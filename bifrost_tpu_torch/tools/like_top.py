"""like_top — a `top`-style curses dashboard over the port's proclog
trees (the port's copy of tools/like_top.py, reading the tree
bifrost_tpu_torch writes; reference tools/like_top.py:1-455 — per-block
acquire/reserve/process times, load/CPU/memory headers, sortable
columns).

Panels:
  - system header: load average, CPU usage (aggregate, from /proc/stat
    deltas), memory (from /proc/meminfo)
  - per-block table: last-gulp acquire/reserve/process seconds plus the
    CUMULATIVE per-phase totals the pipeline keeps, and the derived
    ring-stall % = (total_acquire + total_reserve) / total_all — the
    per-block form of bench.py's stall_pct
  - ring panel: capacity and live backlog % (bytes reserved beyond the
    slowest guaranteed reader's frontier, over capacity; rings log
    geometry on a 0.25 s throttle from the commit path)
  - capture panel: UDP capture good/missing byte counters and
    invalid/late/repeat packet counts (udp_capture stats proclog)
  - supervise panel: pipeline-supervision health — restarts, heartbeat
    misses, deadman interrupts, shed frames, escalations (written by
    supervise.Supervisor to the <pipeline>/supervise proclog)
  - service panel: service-layer health — state (running/degraded/
    escalated/stopped), uptime, restart recoveries with p50/p99 recovery
    time, frame-continuity counters, candidate count (written by
    service.Service's health pusher to the <pipeline>/service proclog)
  - fleet panel: fleet-scheduler health — tenants running/queued,
    admission/rejection/preemption counters, aggregate restarts and
    frame continuity, mesh availability (written by
    fleet.FleetScheduler's control loop to the <fleet>/fleet proclog)
  - fusion panel: the fusion compiler's decision record — per-pipeline
    group count, ring hops eliminated, refusal count, and one row per
    fused GROUP naming its rule and constituent blocks (published by
    fuse.FusionPlan to the <pipeline>/fusion_plan proclog), so the
    fused topology behind the per-block table is visible in place

Keys: q quit; sort by i=pid b=block c=core a=acquire r=reserve p=process
t=total s=stall% (pressing the active key reverses the order).
Usage: python -m bifrost_tpu_torch.tools.like_top [pid ...]
(no pid = all live bifrost_tpu_torch processes).  Non-interactive
(piped) output prints one text snapshot of every panel; with no port
tree to read it says so and exits 1.
"""

import curses
import os
import sys
import time

from ..proclog import (load_by_pid, list_pids, ring_metrics,
                       capture_metrics, stall_pct, supervise_metrics,
                       service_metrics, fleet_metrics, fusion_metrics)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def read_cpu_times():
    """Aggregate (busy, total) jiffies from /proc/stat."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()[1:]
        vals = [int(v) for v in parts[:8]]
        total = sum(vals)
        idle = vals[3] + (vals[4] if len(vals) > 4 else 0)
        return total - idle, total
    except (OSError, ValueError, IndexError):
        return 0, 0


def read_meminfo():
    """-> (total_kb, available_kb)."""
    total = avail = 0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return total, avail


def gather(pids):
    """-> (block_rows, ring_rows, capture_rows, supervise_rows,
    service_rows, fleet_rows, fusion_rows) from the proclog trees."""
    blocks, rings, captures, health, services = [], [], [], [], []
    fleets, fusions = [], []
    for pid in pids:
        tree = load_by_pid(pid)
        for r in supervise_metrics(tree):
            health.append({"pid": pid, **r})
        for r in service_metrics(tree):
            services.append({"pid": pid, **r})
        for r in fleet_metrics(tree):
            fleets.append({"pid": pid, **r})
        for r in fusion_metrics(tree):
            fusions.append({"pid": pid, **r})
        for r in ring_metrics(tree):
            rings.append({"pid": pid, "ring": r["name"],
                          "capacity": r["capacity_total"],
                          "fill": r["backlog_frac"], "head": r["head"]})
        for r in capture_metrics(tree):
            captures.append({"pid": pid, "capture": r["name"],
                             "good": r["good_bytes"],
                             "missing": r["missing_bytes"],
                             "invalid": r["invalid"], "late": r["late"],
                             "repeat": r["repeat"]})
        for name, logs in sorted(tree.items()):
            perf = logs.get("perf", {})
            bind = logs.get("bind", {})
            if not perf and not bind:
                continue
            acquire = perf.get("acquire_time", 0.0) or 0.0
            reserve = perf.get("reserve_time", 0.0) or 0.0
            process = perf.get("process_time", 0.0) or 0.0
            t_acq = perf.get("total_acquire_time", 0.0) or 0.0
            t_res = perf.get("total_reserve_time", 0.0) or 0.0
            t_pro = perf.get("total_process_time", 0.0) or 0.0
            t_com = perf.get("total_commit_time", 0.0) or 0.0
            t_all = t_acq + t_res + t_pro + t_com
            stall = (stall_pct(perf) or 0.0) / 100.0  # shared definition
            blocks.append({
                "pid": pid, "block": name,
                "core": bind.get("core", -1),
                "acquire": acquire, "reserve": reserve, "process": process,
                "total": t_all, "stall": stall,
            })
    return blocks, rings, captures, health, services, fleets, fusions


SORT_KEYS = {ord("i"): "pid", ord("b"): "block", ord("c"): "core",
             ord("a"): "acquire", ord("r"): "reserve", ord("p"): "process",
             ord("t"): "total", ord("s"): "stall"}


def draw(stdscr, pids):
    stdscr.nodelay(True)
    sort_key, sort_rev = "process", True
    prev_cpu = read_cpu_times()
    while True:
        try:
            c = stdscr.getch()
        except curses.error:
            c = -1
        if c in (ord("q"), ord("Q")):
            return
        if c in SORT_KEYS:
            new_key = SORT_KEYS[c]
            sort_rev = (not sort_rev) if new_key == sort_key else True
            sort_key = new_key
        live = [p for p in (pids or list_pids()) if _pid_alive(p)]
        (blocks, rings, captures, health, services, fleets,
         fusions) = gather(live)
        blocks.sort(key=lambda r: r[sort_key], reverse=sort_rev)
        stdscr.erase()
        maxy, maxx = stdscr.getmaxyx()

        try:
            load = os.getloadavg()
        except OSError:
            load = (0, 0, 0)
        cpu = read_cpu_times()
        dbusy, dtotal = cpu[0] - prev_cpu[0], cpu[1] - prev_cpu[1]
        prev_cpu = cpu
        cpu_pct = 100.0 * dbusy / dtotal if dtotal > 0 else 0.0
        mem_total, mem_avail = read_meminfo()
        y = 0

        def put(line, attr=curses.A_NORMAL):
            nonlocal y
            if y < maxy - 1:
                stdscr.addstr(y, 0, line[:maxx - 1], attr)
                y += 1

        put(f"like_top - {time.strftime('%H:%M:%S')}  procs: {len(live)}  "
            f"load: {load[0]:.2f} {load[1]:.2f} {load[2]:.2f}  "
            f"sort: {sort_key}{'v' if sort_rev else '^'}")
        put(f"CPU: {cpu_pct:5.1f}%  Mem: {mem_total // 1024} MB total, "
            f"{(mem_total - mem_avail) // 1024} MB used")
        put("")
        put(f"{'PID':>7} {'Core':>4} {'Acquire':>9} {'Reserve':>9} "
            f"{'Process':>9} {'Total(s)':>9} {'Stall%':>7}  Block",
            curses.A_REVERSE)
        for r in blocks:
            put(f"{r['pid']:>7} {r['core']:>4} {r['acquire']:>9.6f} "
                f"{r['reserve']:>9.6f} {r['process']:>9.6f} "
                f"{r['total']:>9.2f} {100 * r['stall']:>6.1f}%  {r['block']}")
        if rings:
            put("")
            put(f"{'PID':>7} {'Cap MB':>8} {'Backlog%':>8}  Ring",
                curses.A_REVERSE)
            for r in rings:
                put(f"{r['pid']:>7} {r['capacity'] / 1e6:>8.1f} "
                    f"{100 * r['fill']:>7.1f}%  {r['ring']}")
        if captures:
            put("")
            put(f"{'PID':>7} {'Good MB':>9} {'Miss MB':>9} {'Inval':>6} "
                f"{'Late':>6} {'Rept':>6}  Capture", curses.A_REVERSE)
            for r in captures:
                put(f"{r['pid']:>7} {r['good'] / 1e6:>9.1f} "
                    f"{r['missing'] / 1e6:>9.1f} {r['invalid']:>6} "
                    f"{r['late']:>6} {r['repeat']:>6}  {r['capture']}")
        if health:
            put("")
            put(f"{'PID':>7} {'Rstrt':>6} {'HBmiss':>7} {'Deadmn':>7} "
                f"{'Shed':>8} {'Escal':>6}  Supervise", curses.A_REVERSE)
            for r in health:
                put(f"{r['pid']:>7} {r['restarts']:>6} "
                    f"{r['heartbeat_misses']:>7} "
                    f"{r['deadman_interrupts']:>7} {r['shed_frames']:>8} "
                    f"{r['escalations']:>6}  {r['name']}")
        if services:
            put("")
            put(f"{'PID':>7} {'State':>9} {'Up(s)':>8} {'Rcvr':>5} "
                f"{'p50ms':>7} {'p99ms':>7} {'Lost':>6} {'Dup':>5} "
                f"{'Cand':>6}  Service", curses.A_REVERSE)
            for r in services:
                p50 = r.get("recovery_p50_s")
                p99 = r.get("recovery_p99_s")
                put(f"{r['pid']:>7} {r.get('state', '?'):>9} "
                    f"{r.get('uptime_s', 0):>8.1f} "
                    f"{r.get('recoveries', 0):>5} "
                    f"{1e3 * p50 if p50 is not None else 0:>7.1f} "
                    f"{1e3 * p99 if p99 is not None else 0:>7.1f} "
                    f"{r.get('lost_frames', 0):>6} "
                    f"{r.get('duplicated_frames', 0):>5} "
                    f"{r.get('ncandidates', 0):>6}  {r['name']}")
        if fleets:
            put("")
            put(f"{'PID':>7} {'State':>9} {'Run':>4} {'Que':>4} "
                f"{'Adm':>4} {'Rej':>4} {'Pre':>4} {'Rstrt':>6} "
                f"{'Avail%':>7} {'Lost':>6} {'Dup':>5}  Fleet",
                curses.A_REVERSE)
            for r in fleets:
                put(f"{r['pid']:>7} {r.get('state', '?'):>9} "
                    f"{r.get('tenants_running', 0):>4} "
                    f"{r.get('tenants_queued', 0):>4} "
                    f"{r.get('admitted', 0):>4} {r.get('rejected', 0):>4} "
                    f"{r.get('preempted', 0):>4} {r.get('restarts', 0):>6} "
                    f"{r.get('availability_pct', 100.0):>7.2f} "
                    f"{r.get('lost_frames', 0):>6} "
                    f"{r.get('duplicated_frames', 0):>5}  {r['name']}")
        if fusions:
            put("")
            put(f"{'PID':>7} {'Fuse':>5} {'Groups':>7} {'Hops':>5} "
                f"{'Refusd':>7}  Fusion", curses.A_REVERSE)
            for r in fusions:
                put(f"{r['pid']:>7} {'on' if r['pipeline_fuse'] else 'off':>5} "
                    f"{r['groups']:>7} {r['ring_hops_eliminated']:>5} "
                    f"{len(r['refused']):>7}  {r['name']}")
                for g in r["group_rows"]:
                    put(f"{'':>7} {'':>5} {'':>7} "
                        f"{g.get('ring_hops_eliminated', 0):>5} {'':>7}  "
                        f"  {g.get('rule', '?')}: "
                        f"{'+'.join(g.get('constituents', []))}")
        stdscr.refresh()
        time.sleep(1.0)


def snapshot(pids):
    live = [p for p in (pids or list_pids()) if _pid_alive(p) and
            load_by_pid(p)]
    if not live:
        print("no live bifrost_tpu_torch pipelines found", file=sys.stderr)
        return 1
    (blocks, rings, captures, health, services, fleets,
     fusions) = gather(live)
    for r in blocks:
        print(f"block pid={r['pid']} core={r['core']} "
              f"acquire={r['acquire']:.6f} reserve={r['reserve']:.6f} "
              f"process={r['process']:.6f} total={r['total']:.3f} "
              f"stall_pct={100 * r['stall']:.1f} name={r['block']}")
    for r in rings:
        print(f"ring pid={r['pid']} capacity={r['capacity']} "
              f"backlog_pct={100 * r['fill']:.1f} head={r['head']} "
              f"name={r['ring']}")
    for r in captures:
        print(f"capture pid={r['pid']} good_bytes={r['good']} "
              f"missing_bytes={r['missing']} invalid={r['invalid']} "
              f"late={r['late']} repeat={r['repeat']} name={r['capture']}")
    for r in health:
        print(f"supervise pid={r['pid']} restarts={r['restarts']} "
              f"heartbeat_misses={r['heartbeat_misses']} "
              f"deadman={r['deadman_interrupts']} shed={r['shed_frames']} "
              f"escalations={r['escalations']} name={r['name']}")
    for r in services:
        print(f"service pid={r['pid']} state={r.get('state', '?')} "
              f"uptime_s={r.get('uptime_s', 0)} "
              f"degraded={r.get('degraded', 0)} "
              f"restarts={r.get('restarts', 0)} "
              f"recoveries={r.get('recoveries', 0)} "
              f"recovery_p50_s={r.get('recovery_p50_s', '')} "
              f"recovery_p99_s={r.get('recovery_p99_s', '')} "
              f"committed={r.get('committed_frames', 0)} "
              f"lost={r.get('lost_frames', 0)} "
              f"dup={r.get('duplicated_frames', 0)} "
              f"candidates={r.get('ncandidates', 0)} name={r['name']}")
    for r in fleets:
        print(f"fleet pid={r['pid']} state={r.get('state', '?')} "
              f"running={r.get('tenants_running', 0)} "
              f"queued={r.get('tenants_queued', 0)} "
              f"admitted={r.get('admitted', 0)} "
              f"rejected={r.get('rejected', 0)} "
              f"preempted={r.get('preempted', 0)} "
              f"restarts={r.get('restarts', 0)} "
              f"availability_pct={r.get('availability_pct', 100.0)} "
              f"lost={r.get('lost_frames', 0)} "
              f"dup={r.get('duplicated_frames', 0)} name={r['name']}")
    for r in fusions:
        print(f"fusion pid={r['pid']} "
              f"pipeline_fuse={r['pipeline_fuse']} "
              f"groups={r['groups']} "
              f"ring_hops_eliminated={r['ring_hops_eliminated']} "
              f"refused={len(r['refused'])} name={r['name']}")
        for g in r["group_rows"]:
            print(f"fusion_group pid={r['pid']} "
                  f"rule={g.get('rule', '?')} "
                  f"hops={g.get('ring_hops_eliminated', 0)} "
                  f"constituents={'+'.join(g.get('constituents', []))} "
                  f"name={g.get('name', '?')}")
    return 0


def main():
    pids = [int(a) for a in sys.argv[1:]] if len(sys.argv) > 1 else None
    if not sys.stdout.isatty():
        return snapshot(pids)
    curses.wrapper(draw, pids)
    return 0


if __name__ == "__main__":
    sys.exit(main())
