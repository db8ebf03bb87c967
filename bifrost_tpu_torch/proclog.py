"""ProcLog: write and read the per-process metrics tree (counterpart of
bifrost_tpu/proclog.py; its writer is the C engine's cpp/src/proclog.cpp,
restated here in Python).

Layout: ``<root>/<pid>/<logname>``, where a log name may hold '/'
(``<block>/perf``, ``<pipeline>/supervise``).  Each log is a small text
file of ``key : value`` lines, rewritten whole through a ``.tmp`` file
and a rename, so a reader never sees a torn write.  The process's
directory is removed at a clean exit, and directories of processes that
are gone are removed when the first log of a process is created.

The root is the port's own (`proclog_root`): ``$BT_TORCH_PROCLOG_DIR``
when set, else ``bifrost_tpu_torch_proclog`` in the temporary directory
(``tempfile.gettempdir()``).  The JAX package writes its tree elsewhere
and removes its pid directory at its own exit, so the two packages never
share a directory, even in one process.

Writers throttle themselves: a block's per-gulp perf update is written
at most every `PERF_FLUSH_S` seconds (pipeline.py), as the JAX package's
callers throttle theirs.
"""

from __future__ import annotations

import atexit
import fcntl
import json
import os
import shutil
import tempfile
import threading

__all__ = ["ProcLog", "proclog_root", "proclog_dir", "load_by_pid",
           "ring_metrics", "capture_metrics", "stall_pct",
           "supervise_metrics", "service_metrics", "fusion_metrics",
           "fleet_metrics", "cmdline", "list_pids", "PERF_FLUSH_S"]

PERF_FLUSH_S = 0.25   # least seconds between two perf-log writes of a block

_lock = threading.Lock()
_pid_dir = None


def proclog_root():
    """The directory that holds one directory per writing process."""
    env = os.environ.get("BT_TORCH_PROCLOG_DIR")
    if env:
        return env
    return os.path.join(tempfile.gettempdir(), "bifrost_tpu_torch_proclog")


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _cleanup_stale(root):
    """Remove the directories of processes that are gone, serialised
    across processes by a lock file (cpp/src/proclog.cpp cleanup_stale)."""
    try:
        fd = os.open(os.path.join(root, ".lock"), os.O_CREAT | os.O_RDWR,
                     0o666)
    except OSError:
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        os.close(fd)
        return
    try:
        for name in os.listdir(root):
            if name.isdigit() and not _pid_alive(int(name)):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def _remove_pid_dir():
    d = _pid_dir
    if d is not None and os.path.basename(d) == str(os.getpid()):
        shutil.rmtree(d, ignore_errors=True)


def proclog_dir():
    """This process's directory, made (and stale ones cleaned) at first
    use."""
    global _pid_dir
    with _lock:
        if _pid_dir is None or \
                os.path.basename(_pid_dir) != str(os.getpid()):
            root = proclog_root()
            os.makedirs(root, exist_ok=True)
            _cleanup_stale(root)
            _pid_dir = os.path.join(root, str(os.getpid()))
            os.makedirs(_pid_dir, exist_ok=True)
            atexit.register(_remove_pid_dir)
        return _pid_dir


class ProcLog(object):
    """One log of the tree: `update(dict or str)` rewrites it."""

    def __init__(self, name):
        self.name = name
        self.path = os.path.join(proclog_dir(), name)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w"):
            pass

    def update(self, contents):
        """contents: dict -> 'key : value' lines, or a raw string."""
        if isinstance(contents, dict):
            contents = "".join(f"{k} : {v}\n" for k, v in contents.items())
        tmp = f"{self.path}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write(contents)
            os.replace(tmp, self.path)
        except FileNotFoundError:
            # The directory went away under a live writer (a clean exit
            # racing a daemon thread): observability only.
            pass

    def remove(self):
        """Unlink the log (cpp/src/proclog.cpp btProcLogDestroy)."""
        try:
            os.unlink(self.path)
        except OSError:
            pass


# ------------------------------------------------------------------ readers
def _parse_value(v):
    v = v.strip()
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def load_by_pid(pid, include_rings=True, root=None):
    """Parse a process's tree into {block: {log: {key: value}}}
    (bifrost_tpu/proclog.py:42-70).  `root`: the tree's root directory
    (default: the port's, `proclog_root()`); pass the JAX package's to
    read the tree it writes."""
    piddir = os.path.join(root or proclog_root(), str(pid))
    contents = {}
    if not os.path.isdir(piddir):
        return contents
    for base, _dirs, files in os.walk(piddir):
        for fname in files:
            if fname.endswith(".tmp"):
                continue
            path = os.path.join(base, fname)
            parts = os.path.relpath(path, piddir).split(os.sep)
            if not include_rings and parts[0] == "rings":
                continue
            block = os.sep.join(parts[:-1]) if len(parts) > 1 else parts[0]
            entry = {}
            try:
                with open(path, "r") as f:
                    for line in f:
                        if ":" not in line:
                            continue
                        k, _, v = line.partition(":")
                        entry[k.strip()] = _parse_value(v)
            except OSError:
                continue
            contents.setdefault(block, {})[parts[-1]] = entry
    return contents


def ring_metrics(tree):
    """One geometry row per ring of a load_by_pid tree (bifrost_tpu/
    proclog.py:73-100): every ring logs under the shared `rings`
    directory, so each of its logs is a row.  The backlog is read from
    the slowest guaranteed reader's frontier (`guarantee`), not the tail,
    which moves only at reserve time.

    -> [{name, capacity_total, nringlet, head, backlog_frac}]."""
    rows = []
    for block, logs in sorted(tree.items()):
        for log, kv in sorted(logs.items()):
            if "capacity" not in kv or "reserve_head" not in kv:
                continue
            cap = kv.get("capacity", 0) or 0
            guarantee = kv.get("guarantee", kv.get("head", 0))
            backlog = ((kv.get("reserve_head", 0) - guarantee) / cap
                       if cap else 0.0)
            name = log if block == "rings" else f"{block}/{log}"
            rows.append({"name": name,
                         "capacity_total": cap * kv.get("nringlet", 1),
                         "nringlet": kv.get("nringlet", 1),
                         "head": kv.get("head", 0),
                         "backlog_frac": max(0.0, min(1.0, backlog))})
    return rows


def capture_metrics(tree):
    """UDP-capture rows from a load_by_pid tree (bifrost_tpu/proclog.py:
    103-135).  The JAX engine keeps a throttled byte-count `stats` log of
    its own beside the per-sequence `packet_stats` push; the port's engine
    writes only the push (udp.UDPCapture(stats_name=...)), with the same
    keys, so a `stats` log is read the same way where one exists: the row
    with more observed traffic wins.

    -> [{name, good_bytes, missing_bytes, invalid, late, repeat
         [, good, missing, nsequence]}]."""
    rows = []
    for block, logs in sorted(tree.items()):
        stats = logs.get("stats", {})
        push = logs.get("packet_stats", {})
        if push and "ngood_bytes" in push and \
                push.get("ngood_bytes", 0) >= stats.get("ngood_bytes", 0):
            rows.append({"name": block,
                         "good_bytes": push.get("ngood_bytes", 0),
                         "missing_bytes": push.get("nmissing_bytes", 0),
                         "invalid": push.get("ninvalid", 0),
                         "late": push.get("nlate", 0),
                         "repeat": push.get("nrepeat", 0),
                         "good": push.get("ngood", 0),
                         "missing": push.get("nmissing", 0),
                         "nsequence": push.get("nsequence", 0)})
        elif stats and "ngood_bytes" in stats:
            rows.append({"name": block,
                         "good_bytes": stats.get("ngood_bytes", 0),
                         "missing_bytes": stats.get("nmissing_bytes", 0),
                         "invalid": stats.get("ninvalid", 0),
                         "late": stats.get("nlate", 0),
                         "repeat": stats.get("nrepeat", 0)})
    return rows


def stall_pct(perf):
    """A block's ring stall in %% of its loop time, from its perf log:
    the time blocked acquiring input and reserving output over the sum
    of its phase totals; None before the block has written totals.  The
    one definition the tools share."""
    stall = perf.get("total_acquire_time", 0.0) + \
        perf.get("total_reserve_time", 0.0)
    total = sum(v for k, v in perf.items()
                if k.startswith("total_") and isinstance(v, (int, float)))
    return 100.0 * stall / total if total else None


def supervise_metrics(tree):
    """Supervision rows from a load_by_pid tree (one `<pipeline>/supervise`
    log per supervised pipeline, written by supervise.Supervisor)."""
    rows = []
    for block, logs in sorted(tree.items()):
        kv = logs.get("supervise", {})
        if not kv or "restarts" not in kv:
            continue
        rows.append({"name": block,
                     "faults": kv.get("faults", 0),
                     "restarts": kv.get("restarts", 0),
                     "heartbeat_misses": kv.get("heartbeat_misses", 0),
                     "deadman_interrupts": kv.get("deadman_interrupts", 0),
                     "shed_frames": kv.get("shed_frames", 0),
                     "escalations": kv.get("escalations", 0),
                     "recoveries": kv.get("recoveries", 0),
                     "recovery_p50_s": kv.get("recovery_p50_s", None),
                     "recovery_p99_s": kv.get("recovery_p99_s", None),
                     "last_event": kv.get("last_event", "")})
    return rows


def service_metrics(tree):
    """Service health rows from a load_by_pid tree (one
    `<pipeline>/service` log per running service, written by
    service.Service's health pusher); the JSON snapshot is left out."""
    rows = []
    for block, logs in sorted(tree.items()):
        kv = logs.get("service", {})
        if not kv or "state" not in kv:
            continue
        row = {"name": block}
        row.update({k: v for k, v in kv.items() if k != "snapshot"})
        rows.append(row)
    return rows


def fusion_metrics(tree):
    """The fusion planner's decision rows from a load_by_pid tree (one
    `<pipeline>/fusion_plan` log per pipeline, written by fuse.py).

    -> [{name, pipeline_fuse, groups, ring_hops_eliminated,
         refused: {block: reason}, group_rows: [{name, rule,
         constituents, ring_hops_eliminated}]}]."""
    rows = []
    for block, logs in sorted(tree.items()):
        kv = logs.get("fusion_plan", {})
        if not kv or "groups" not in kv:
            continue
        group_rows = []
        for i in range(int(kv.get("groups", 0) or 0)):
            try:
                group_rows.append(json.loads(kv.get(f"group{i}") or ""))
            except (TypeError, ValueError):
                continue
        try:
            refused = json.loads(kv.get("refused", "{}") or "{}")
        except (TypeError, ValueError):
            refused = {}
        rows.append({"name": block,
                     "pipeline_fuse": kv.get("pipeline_fuse", 0),
                     "groups": kv.get("groups", 0),
                     "ring_hops_eliminated":
                         kv.get("ring_hops_eliminated", 0),
                     "refused": refused,
                     "group_rows": group_rows})
    return rows


def fleet_metrics(tree):
    """Fleet-scheduler health rows from a load_by_pid tree (one
    `<fleet>/fleet` log per running scheduler, written by
    fleet.FleetScheduler's health pusher); the JSON snapshot is left out.

    -> [{name, state, uptime_s, tenants_running, tenants_queued,
         admitted, rejected, preempted, completed, quota_violations,
         restarts, availability_pct, committed_frames, lost_frames,
         duplicated_frames[, recovery_p50_s, recovery_p99_s]}]."""
    rows = []
    for block, logs in sorted(tree.items()):
        kv = logs.get("fleet", {})
        if not kv or "tenants_running" not in kv:
            continue
        row = {"name": block}
        row.update({k: v for k, v in kv.items() if k != "snapshot"})
        rows.append(row)
    return rows


def cmdline(pid):
    """The process's command line, space-joined ('?' if unreadable)."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode().strip()
    except OSError:
        return "?"


def list_pids(pipelines_only=False, root=None):
    """The live processes with a tree under `root` (default: the port's),
    never this process (a tool reading the tree).  `pipelines_only`
    keeps those with a block's `in` log: every block writes one."""
    base = root or proclog_root()
    pids = []
    if not os.path.isdir(base):
        return pids
    for name in os.listdir(base):
        if not name.isdigit() or int(name) == os.getpid() or \
                not _pid_alive(int(name)):
            continue
        if pipelines_only and not any(
                "in" in files and os.path.basename(d) != "rings"
                for d, _dirs, files in os.walk(os.path.join(base, name))):
            continue
        pids.append(int(name))
    return sorted(pids)
