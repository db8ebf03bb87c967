"""PSRDADA-style SysV IPC ring buffers over libc, no libpsrdada
(counterpart of bifrost_tpu/io/dada_ipc.py, of which this is a copy).

The reference binds the external PSRDADA library (reference
python/bifrost/psrdada.py:38-257: ipcbuf/ipcio open, mark filled/cleared,
start/end of data).  This module speaks the protocol that library speaks
(System-V shared-memory buffer rings with semaphore flow control and a
sync page carrying the transfer bookkeeping) directly over libc through
ctypes, so a DADA producer and consumer need no external library, and
``python -m bifrost_tpu_torch.dada_bridge`` forwards such a ring into the
port's shm ring.

Layout (the knobs at the top mirror psrdada's ipcbuf.h, and are the JAX
module's, so a ring made by either package is read by the other):
- sync page: one shm segment at `key`, struct IpcSync: the nbufs/bufsz
  geometry, writer and reader buffer counts, transfer records
  (IPCBUF_XFERS slots) and each buffer's committed size.
- data buffers: `nbufs` shm segments at key+1 .. key+nbufs.
- flow control: one semaphore set at `key`, [FULL, CLEAR, SODACK, EODACK];
  the writer waits CLEAR and posts FULL a buffer, the reader waits FULL and
  posts CLEAR (ipcbuf's counting discipline).
- an HDU pairs a header ring at `key + HDR_KEY_OFFSET` with a data ring at
  `key`, as dada_db's header and data blocks.

psrdada's struct packing and key scheme vary by version: attaching to a
segment made by a site's `dada_db` needs the constants below checked
against that site's ipcbuf.h.  Attaching (create=False) validates the
segment before any use (the sync segment's size against sizeof(IpcSync),
magic and layout version, nbufs/bufsz, the semaphore count, each buffer's
size) and raises a RuntimeError naming the mismatch.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading
import time

# ---------------------------------------------------------------- knobs
IPCBUF_XFERS = 8          # in-flight transfer records (psrdada ipcbuf.h)
IPCBUF_MAX_NBUFS = 64     # sync page carries per-buffer commit sizes
HDR_KEY_OFFSET = 0x100    # header-block key = data key + this (dada_db)
SEM_FULL, SEM_CLEAR, SEM_SODACK, SEM_EODACK = 0, 1, 2, 3
DEFAULT_HEADER_SIZE = 4096   # DADA ASCII header page

IPC_CREAT = 0o1000
IPC_EXCL = 0o2000
IPC_RMID = 0
IPC_STAT = 2

_libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                    use_errno=True)
_libc.shmat.restype = ctypes.c_void_p
_libc.shmat.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]


def _err(call):
    e = ctypes.get_errno()
    raise OSError(e, f"{call}: {os.strerror(e)}")


def _shmget(key, size, flags):
    shmid = _libc.shmget(ctypes.c_int(key), ctypes.c_size_t(size),
                         ctypes.c_int(flags))
    if shmid < 0:
        _err(f"shmget(key=0x{key:x}, size={size})")
    return shmid


def _shmat(shmid):
    addr = _libc.shmat(shmid, None, 0)
    if addr in (None, ctypes.c_void_p(-1).value):
        _err("shmat")
    return addr


def _shm_rm(shmid):
    _libc.shmctl(shmid, IPC_RMID, None)


def _shmdt(addr):
    _libc.shmdt(ctypes.c_void_p(addr))


class _sembuf(ctypes.Structure):
    _fields_ = [("sem_num", ctypes.c_ushort),
                ("sem_op", ctypes.c_short),
                ("sem_flg", ctypes.c_short)]


def _semget(key, nsems, flags):
    semid = _libc.semget(ctypes.c_int(key), ctypes.c_int(nsems),
                         ctypes.c_int(flags))
    if semid < 0:
        _err(f"semget(key=0x{key:x})")
    return semid


def _semop(semid, num, op, timeout=None):
    """semop with optional timeout (polling loop — portable and
    adequate for ring cadences)."""
    buf = _sembuf(num, op, 0)
    if timeout is None:
        while _libc.semop(semid, ctypes.byref(buf), 1) < 0:
            if ctypes.get_errno() != 4:   # EINTR: retry, not fatal
                _err("semop")
        return True
    deadline = time.monotonic() + timeout
    nb = _sembuf(num, op, 0o4000)   # IPC_NOWAIT
    while True:
        if _libc.semop(semid, ctypes.byref(nb), 1) == 0:
            return True
        e = ctypes.get_errno()
        if e not in (4, 11):        # EINTR / EAGAIN: retry
            _err("semop")
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.0005)


def _sem_rm(semid):
    _libc.semctl(semid, 0, IPC_RMID, 0)


# ------------------------------------------------ attach-time ABI probes
class _IpcPerm(ctypes.Structure):
    """glibc/Linux struct ipc_perm (the common 48-byte LP64 layout)."""
    _fields_ = [("key", ctypes.c_int),
                ("uid", ctypes.c_uint), ("gid", ctypes.c_uint),
                ("cuid", ctypes.c_uint), ("cgid", ctypes.c_uint),
                ("mode", ctypes.c_ushort), ("_pad1", ctypes.c_ushort),
                ("seq", ctypes.c_ushort), ("_pad2", ctypes.c_ushort),
                ("_res1", ctypes.c_ulong), ("_res2", ctypes.c_ulong)]


class _ShmidDs(ctypes.Structure):
    _fields_ = [("shm_perm", _IpcPerm),
                ("shm_segsz", ctypes.c_size_t),
                ("shm_atime", ctypes.c_long),
                ("shm_dtime", ctypes.c_long),
                ("shm_ctime", ctypes.c_long),
                ("shm_cpid", ctypes.c_int),
                ("shm_lpid", ctypes.c_int),
                ("shm_nattch", ctypes.c_ulong),
                ("_res4", ctypes.c_ulong), ("_res5", ctypes.c_ulong)]


class _SemidDs(ctypes.Structure):
    _fields_ = [("sem_perm", _IpcPerm),
                ("sem_otime", ctypes.c_long),
                ("_res1", ctypes.c_ulong),
                ("sem_ctime", ctypes.c_long),
                ("_res2", ctypes.c_ulong),
                ("sem_nsems", ctypes.c_ulong),
                ("_res3", ctypes.c_ulong), ("_res4", ctypes.c_ulong)]


def _shm_segsz(shmid):
    """Size in bytes of an attached shm segment; None when the
    shmid_ds ABI guess does not hold (validation then degrades to the
    in-page checks rather than rejecting a working ring)."""
    ds = _ShmidDs()
    try:
        if _libc.shmctl(shmid, IPC_STAT, ctypes.byref(ds)) != 0:
            return None
    except Exception:   # noqa: BLE001 — probe is best-effort by design
        return None
    sz = int(ds.shm_segsz)
    return sz if 0 < sz < (1 << 48) else None


def _shm_nattch(shmid):
    """Number of attachments of a shm segment; None when the probe
    fails."""
    ds = _ShmidDs()
    try:
        if _libc.shmctl(shmid, IPC_STAT, ctypes.byref(ds)) != 0:
            return None
    except Exception:   # noqa: BLE001 — probe is best-effort by design
        return None
    return int(ds.shm_nattch)


def _sem_nsems(semid):
    """Number of semaphores in a set; None when the probe fails."""
    ds = _SemidDs()
    try:
        if _libc.semctl(semid, 0, IPC_STAT, ctypes.byref(ds)) != 0:
            return None
    except Exception:   # noqa: BLE001
        return None
    n = int(ds.sem_nsems)
    return n if 0 < n < 65536 else None


# ------------------------------------------------------------ sync page
class IpcSync(ctypes.Structure):
    """The ring's shared bookkeeping page (ipcbuf.h's ipcsync_t shape:
    geometry, write/read cursors, transfer records)."""
    _fields_ = [
        ("magic", ctypes.c_uint64),          # layout guard
        ("nbufs", ctypes.c_uint64),
        ("bufsz", ctypes.c_uint64),
        ("w_buf", ctypes.c_uint64),          # bufs written (count)
        ("w_xfer", ctypes.c_uint64),         # current write transfer
        ("r_buf", ctypes.c_uint64),          # bufs read (count)
        ("r_xfer", ctypes.c_uint64),         # current read transfer
        ("s_buf", ctypes.c_uint64 * IPCBUF_XFERS),   # SOD buffer
        ("s_byte", ctypes.c_uint64 * IPCBUF_XFERS),  # SOD byte offset
        ("e_buf", ctypes.c_uint64 * IPCBUF_XFERS),   # EOD buffer
        ("e_byte", ctypes.c_uint64 * IPCBUF_XFERS),  # EOD byte in buf
        ("eod", ctypes.c_uint8 * IPCBUF_XFERS),      # EOD flag
        # Per-buffer committed sizes, written BEFORE the buffer's FULL
        # token is posted: the reader never has to infer a partial size
        # from EOD flags, so the mark_filled/end_of_data ordering race
        # psrdada avoids with enable_eod cannot arise at all.
        ("buf_nbyte", ctypes.c_uint64 * IPCBUF_MAX_NBUFS),
    ]


MAGIC = 0xDADA0001


class DadaRing(object):
    """One PSRDADA-style buffer ring (the ipcbuf layer).

    create=True builds the segments (the `dada_db` role); False attaches
    to existing ones.  Exactly one writer and one reader are supported
    (psrdada's common single-reader configuration).
    """

    def __init__(self, key, nbufs=4, bufsz=1 << 20, create=False,
                 destroy_on_close=None):
        if create and nbufs > IPCBUF_MAX_NBUFS:
            raise ValueError(f"nbufs > {IPCBUF_MAX_NBUFS} not supported")
        self.key = int(key)
        self.create = bool(create)
        self.destroy_on_close = (self.create if destroy_on_close is None
                                 else destroy_on_close)
        # Handle-local (this process only): lets a pipeline shutdown wake
        # a writer blocked on the CLEAR semaphore behind a stalled
        # external consumer (see open_write_buf / interrupt).
        self._interrupted = threading.Event()
        if create:
            self.syncid = _shmget(self.key, ctypes.sizeof(IpcSync),
                                  IPC_CREAT | IPC_EXCL | 0o666)
            self.semid = _semget(self.key, 4, IPC_CREAT | IPC_EXCL | 0o666)
        else:
            self.syncid = _shmget(self.key, 0, 0)
            self.semid = _semget(self.key, 0, 0)
        if not create:
            # Attach-time ABI validation, BEFORE mapping the struct: a
            # segment built by a different psrdada build (or not a DADA
            # ring at all) must fail loudly here, not silently misread
            # geometry and corrupt both sides.
            segsz = _shm_segsz(self.syncid)
            if segsz is not None and segsz < ctypes.sizeof(IpcSync):
                raise RuntimeError(
                    f"key 0x{self.key:x}: sync segment is {segsz} B but "
                    f"this implementation's IpcSync needs "
                    f"{ctypes.sizeof(IpcSync)} B — struct-size mismatch "
                    "(created by an incompatible psrdada build? see "
                    "module docstring on ABI variance)")
        mapped = []
        try:
            addr = _shmat(self.syncid)
            mapped.append(addr)
            self.sync = IpcSync.from_address(addr)
            if create:
                ctypes.memset(addr, 0, ctypes.sizeof(IpcSync))
                self.sync.magic = MAGIC
                self.sync.nbufs = nbufs
                self.sync.bufsz = bufsz
                # all buffers start clear
                for _ in range(nbufs):
                    _semop(self.semid, SEM_CLEAR, 1)
            elif self.sync.magic != MAGIC:
                if (self.sync.magic >> 16) == (MAGIC >> 16):
                    raise RuntimeError(
                        f"key 0x{self.key:x}: sync page layout version "
                        f"{self.sync.magic & 0xFFFF} != "
                        f"{MAGIC & 0xFFFF} — ring created by an "
                        "incompatible version of this implementation")
                raise RuntimeError(
                    f"key 0x{self.key:x}: sync page magic "
                    f"0x{self.sync.magic:x} != 0x{MAGIC:x} — not a ring "
                    "created by this implementation (see module "
                    "docstring on psrdada ABI variance)")
            if not create:
                nbufs_s = int(self.sync.nbufs)
                bufsz_s = int(self.sync.bufsz)
                if not 0 < nbufs_s <= IPCBUF_MAX_NBUFS:
                    raise RuntimeError(
                        f"key 0x{self.key:x}: sync page advertises "
                        f"nbufs={nbufs_s} (valid: 1..{IPCBUF_MAX_NBUFS}) "
                        "— corrupt or incompatible sync page")
                if bufsz_s == 0:
                    raise RuntimeError(
                        f"key 0x{self.key:x}: sync page advertises "
                        "bufsz=0 — corrupt or incompatible sync page")
                nsems = _sem_nsems(self.semid)
                if nsems is not None and nsems < 4:
                    raise RuntimeError(
                        f"key 0x{self.key:x}: semaphore set has {nsems} "
                        "sems, this protocol needs 4 (FULL/CLEAR/SODACK/"
                        "EODACK) — not a ring created by this "
                        "implementation")
            self.nbufs = int(self.sync.nbufs)
            self.bufsz = int(self.sync.bufsz)
            self.shmids = []
            self.bufs = []
            for i in range(self.nbufs):
                bkey = self.key + 1 + i
                shmid = _shmget(bkey, self.bufsz if create else 0,
                                (IPC_CREAT | IPC_EXCL | 0o666)
                                if create else 0)
                if not create:
                    dsz = _shm_segsz(shmid)
                    if dsz is not None and dsz < self.bufsz:
                        raise RuntimeError(
                            f"key 0x{self.key:x}: data buffer {i} "
                            f"segment is {dsz} B < advertised bufsz "
                            f"{self.bufsz} — geometry mismatch with "
                            "the sync page")
                self.shmids.append(shmid)
                baddr = _shmat(shmid)
                mapped.append(baddr)
                self.bufs.append((ctypes.c_uint8 * self.bufsz)
                                 .from_address(baddr))
        except Exception:
            # A failed construction (most likely a validation raise
            # against an incompatible segment) must not leak mappings:
            # a supervisor retrying attach in a loop would otherwise
            # accumulate them and keep nattch pinned on segments the
            # owner wants reclaimed.
            self.sync = None
            self.bufs = []
            for a in mapped:
                _shmdt(a)
            raise
        self._closed = False

    # ------------------------------------------------------------ writer
    def open_write_buf(self, timeout=None):
        """-> (memoryview, buf_index) of the next buffer to fill, or
        None on timeout.  The CLEAR wait is sliced so a concurrent
        `interrupt()` (pipeline shutdown behind a stalled external
        consumer) raises InterruptedError promptly instead of waiting
        out the timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._interrupted.is_set():
                raise InterruptedError(
                    f"DADA ring key 0x{self.key:x}: write wait "
                    "interrupted")
            slice_s = 0.1
            if deadline is not None:
                slice_s = min(slice_s, max(0.0,
                                           deadline - time.monotonic()))
            if _semop(self.semid, SEM_CLEAR, -1, slice_s):
                break
            if deadline is not None and time.monotonic() >= deadline:
                return None
        idx = int(self.sync.w_buf) % self.nbufs
        return memoryview(self.bufs[idx]).cast("B"), idx

    def interrupt(self):
        """Wake this handle's blocked `open_write_buf` calls (this
        process only; peers unaffected) — the sink's `on_shutdown`
        hook, so destination back-pressure cannot outlive a bounded
        quiesce."""
        self._interrupted.set()

    def clear_interrupt(self):
        """Re-arm the handle after an interrupt (supervised restart)."""
        self._interrupted.clear()

    def mark_filled(self, nbyte):
        """Commit the opened write buffer with `nbyte` valid bytes."""
        x = int(self.sync.w_xfer) % IPCBUF_XFERS
        w = int(self.sync.w_buf)
        self.sync.buf_nbyte[w % self.nbufs] = nbyte   # before FULL post
        self.sync.e_buf[x] = w + 1           # committed-buffer COUNT
        self.sync.e_byte[x] = nbyte
        self.sync.w_buf = w + 1
        _semop(self.semid, SEM_FULL, 1)

    def start_of_data(self, byte_offset=0):
        x = int(self.sync.w_xfer) % IPCBUF_XFERS
        self.sync.s_buf[x] = int(self.sync.w_buf)
        self.sync.s_byte[x] = byte_offset
        self.sync.eod[x] = 0

    def end_of_data(self):
        x = int(self.sync.w_xfer) % IPCBUF_XFERS
        self.sync.eod[x] = 1
        self.sync.w_xfer = int(self.sync.w_xfer) + 1
        # wake a blocked reader so it can observe EOD
        _semop(self.semid, SEM_FULL, 1)

    # ------------------------------------------------------------ reader
    def open_read_buf(self, timeout=None):
        """-> (memoryview, nbyte) of the next filled buffer, or
        'EOD' when the writer ended the transfer, or None on timeout."""
        if not _semop(self.semid, SEM_FULL, -1, timeout):
            return None
        x = int(self.sync.r_xfer) % IPCBUF_XFERS
        if (self.sync.eod[x] and
                int(self.sync.r_buf) >= int(self.sync.e_buf[x])):
            self.sync.r_xfer = int(self.sync.r_xfer) + 1
            return "EOD"
        idx = int(self.sync.r_buf) % self.nbufs
        # buf_nbyte is written before the FULL token is posted, so the
        # committed size is always coherent — partial buffers (EOD or
        # otherwise) need no flag-ordering inference.
        nbyte = int(self.sync.buf_nbyte[idx])
        return memoryview(self.bufs[idx]).cast("B")[:nbyte], nbyte

    def mark_cleared(self):
        self.sync.r_buf = int(self.sync.r_buf) + 1
        _semop(self.semid, SEM_CLEAR, 1)

    # ------------------------------------------------------------- misc
    def wait_drained(self, timeout):
        """Wait, up to `timeout` s, until the reader has read every ended
        transfer (its EOD included), while another process is attached
        and this handle is not interrupted: the creator removes the
        segments only after its reader is done.  -> True when drained or
        no other process is attached."""
        deadline = time.monotonic() + timeout
        while int(self.sync.r_xfer) < int(self.sync.w_xfer):
            nattch = _shm_nattch(self.syncid)
            if nattch is not None and nattch <= 1:
                return True
            if self._interrupted.is_set() or \
                    time.monotonic() >= deadline:
                return False
            time.sleep(0.001)
        return True

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self.destroy_on_close:
            for shmid in self.shmids:
                _shm_rm(shmid)
            _shm_rm(self.syncid)
            _sem_rm(self.semid)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DadaHDU(object):
    """Header + data ring pair (psrdada's dada_hdu): header ring at
    key + HDR_KEY_OFFSET carries one DADA ASCII page per transfer."""

    def __init__(self, key, nbufs=4, bufsz=1 << 20,
                 header_size=DEFAULT_HEADER_SIZE, create=False):
        self.data = DadaRing(key, nbufs, bufsz, create=create)
        self.header = DadaRing(key + HDR_KEY_OFFSET, 2, header_size,
                               create=create)

    def write_header(self, headerstr):
        buf, _ = self.header.open_write_buf()
        raw = headerstr.encode() if isinstance(headerstr, str) \
            else bytes(headerstr)
        # +1 accounts for the NUL terminator written below: a header
        # exactly filling the buffer must be refused, or mark_filled
        # would commit bufsz + 1 bytes.
        if len(raw) + 1 > len(buf):
            raise ValueError("DADA header exceeds header buffer size")
        buf[:len(raw)] = raw
        buf[len(raw):len(raw) + 1] = b"\0"
        self.header.start_of_data()
        self.header.mark_filled(len(raw) + 1)

    def read_header(self, timeout=None):
        got = self.header.open_read_buf(timeout)
        if got in (None, "EOD"):
            return None
        buf, nbyte = got
        raw = bytes(buf[:nbyte])
        self.header.mark_cleared()
        return raw.split(b"\0", 1)[0].decode(errors="replace")

    def close(self):
        self.data.close()
        self.header.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
