"""like_ps — `ps`-style listing of live bifrost_tpu_torch pipelines and
their blocks (the port's copy of tools/like_ps.py, reading the tree
bifrost_tpu_torch writes; reference tools/like_ps.py — per-process
user/CPU/memory/elapsed details joined with per-block proclog rows,
read from /proc instead of shelling out to `ps`).

Process columns: USER, %CPU (sampled over a short interval), %MEM,
ELAPSED, THREADS.  Block columns: core binding, device, role (in/out
ring counts), live ring-stall %.

Usage: python -m bifrost_tpu_torch.tools.like_ps [-b] [pid ...]
"""

import argparse
import os
import pwd
import sys
import time

from ..proclog import load_by_pid, list_pids, stall_pct, cmdline

_CLK = os.sysconf("SC_CLK_TCK")
_PAGE = os.sysconf("SC_PAGE_SIZE")


def _read_stat(pid):
    """(utime+stime ticks, start_time ticks, nthreads) from /proc/stat."""
    with open(f"/proc/{pid}/stat") as f:
        raw = f.read()
    # comm may contain spaces/parens: split after the LAST ')'
    rest = raw[raw.rindex(")") + 2:].split()
    utime, stime = int(rest[11]), int(rest[12])
    nthreads = int(rest[17])
    start_time = int(rest[19])
    return utime + stime, start_time, nthreads


def _mem_pct(pid):
    try:
        with open(f"/proc/{pid}/statm") as f:
            rss_pages = int(f.read().split()[1])
        with open("/proc/meminfo") as f:
            total_kb = int(f.readline().split()[1])
        return 100.0 * rss_pages * _PAGE / 1024.0 / total_kb
    except (OSError, ValueError, IndexError):
        return 0.0


def _user(pid):
    try:
        uid = os.stat(f"/proc/{pid}").st_uid
        return pwd.getpwuid(uid).pw_name
    except (OSError, KeyError):
        return "?"


def _uptime():
    with open("/proc/uptime") as f:
        return float(f.read().split()[0])


def _elapsed_str(seconds):
    seconds = int(seconds)
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h >= 24:
        return f"{h // 24}d{h % 24:02d}h"
    return f"{h:02d}:{m:02d}:{s:02d}"


def process_details(pids, cpu_sample_s=0.1):
    """{pid: USER/%CPU/%MEM/ELAPSED/THREADS} via /proc (no `ps`
    dependency).  One fixed sample window for ALL pids: t0 for every
    process, one sleep, then t1 — N pipelines cost 100 ms, not N*100."""
    first = {}
    for pid in pids:
        try:
            first[pid] = _read_stat(pid)
        except (OSError, ValueError):
            continue
    w0 = time.monotonic()
    time.sleep(cpu_sample_s)
    wall = time.monotonic() - w0  # sleep oversleeps on loaded hosts
    details = {}
    for pid, (t0, start, _) in first.items():
        try:
            t1, _, nthreads = _read_stat(pid)
        except (OSError, ValueError):
            continue
        cpu_pct = 100.0 * (t1 - t0) / _CLK / wall
        elapsed = _uptime() - start / _CLK
        details[pid] = {"user": _user(pid), "cpu": cpu_pct,
                        "mem": _mem_pct(pid),
                        "elapsed": _elapsed_str(elapsed),
                        "threads": nthreads}
    return details


def _block_rows(tree):
    rows = []
    for block, logs in sorted(tree.items()):
        if block == "rings":
            continue
        bind = logs.get("bind", {})
        nin = sum(1 for k in logs.get("in", {}) if k.startswith("ring"))
        nout = sum(1 for k in logs.get("out", {}) if k.startswith("ring"))
        role = ("source" if nin == 0 and nout else
                "sink" if nout == 0 and nin else
                "transform" if nin else "-")
        pct = stall_pct(logs.get("perf", {}))
        stall_s = f"{pct:5.1f}" if pct is not None else "    -"
        rows.append((block, role, bind.get("core", "-"),
                     str(bind.get("device", "-"))[:10], nin, nout, stall_s))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="ps-style listing of live bifrost_tpu_torch pipelines",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("pids", type=int, nargs="*",
                        help="PIDs to show (default: all live pipelines)")
    parser.add_argument("-b", "--no-blocks", action="store_true",
                        help="process summary only, no per-block rows")
    args = parser.parse_args(argv)

    pids = [p for p in args.pids if load_by_pid(p)] if args.pids else \
        list_pids(pipelines_only=True)
    if not pids:
        print("no live bifrost_tpu_torch pipelines found", file=sys.stderr)
        return 1
    print(f"{'PID':>8} {'USER':<10} {'%CPU':>6} {'%MEM':>5} "
          f"{'ELAPSED':>9} {'THR':>4}  COMMAND")
    details = process_details(pids)
    for pid in pids:
        det = details.get(pid)
        if det is None:
            continue
        print(f"{pid:>8} {det['user']:<10} {det['cpu']:>6.1f} "
              f"{det['mem']:>5.1f} {det['elapsed']:>9} "
              f"{det['threads']:>4}  {cmdline(pid)[:50]}")
        if args.no_blocks:
            continue
        tree = load_by_pid(pid)
        rows = _block_rows(tree)
        if rows:
            print(f"         {'BLOCK':<42} {'ROLE':<9} {'CORE':>4} "
                  f"{'DEVICE':<10} {'IN':>2} {'OUT':>3} {'STALL%':>6}")
        for block, role, core, device, nin, nout, stall in rows:
            print(f"         {block:<42} {role:<9} {core!s:>4} "
                  f"{device:<10} {nin:>2} {nout:>3} {stall:>6}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
