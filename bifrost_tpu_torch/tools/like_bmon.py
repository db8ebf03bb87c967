"""like_bmon — `bmon`-style data-rate monitor over the port's proclogs
(the port's copy of tools/like_bmon.py, reading the tree
bifrost_tpu_torch writes; reference tools/like_bmon.py:1-422 —
per-interface RX/TX rate panels with history graphs).

Two panels, both rate-derived by differencing proclog counters over the
poll interval:
  - rings: head-advance rate (stream throughput), live backlog % (bytes
    reserved beyond the slowest guaranteed reader's frontier), and a
    sparkline of the recent rate history — one row per ring; every ring
    logs head/guarantee at most every 0.25 s from its commits
  - captures: UDP good-payload and missing-payload byte rates plus
    invalid/late/repeat packet counts (the capture's stats proclog)

A TOTAL row sums ring throughput per pid.  'q' quits.  Piped output
prints one snapshot of the current counters (`ring (pid, name) (head,
capacity, nringlet, backlog)` lines), then samples again after the
interval and prints each ring's rate (`rate (pid, name) MB/s` lines; a
ring whose head went back between the samples is a new ring of that
log name and gets no rate line); with no port tree to read it says so
and exits 1.

Usage: python -m bifrost_tpu_torch.tools.like_bmon [-i S] [pid ...]
"""

import argparse
import collections
import curses
import sys
import time

from ..proclog import load_by_pid, list_pids, ring_metrics, capture_metrics

HISTORY = 30
_BARS = " ▁▂▃▄▅▆▇█"


def sparkline(values, width=HISTORY):
    """Render a rate history as a unicode bar strip (self-scaled)."""
    vals = list(values)[-width:]
    top = max(vals) if vals else 0.0
    if top <= 0:
        return " " * len(vals)
    # clamp below too: a pid reuse / counter restart gives one negative
    # rate sample, which must not wrap to a full bar
    return "".join(_BARS[max(0, min(int(v / top * (len(_BARS) - 1)), 8))]
                   for v in vals)


def _rate(ohead, head, nringlet, dt):
    """MB/s of a ring whose head went from `ohead` to `head` in `dt` s.
    A head that went back is a new ring under the log's name (the old
    one was destroyed and its name taken again): no rate, 0."""
    return (head - ohead) * nringlet / dt / 1e6 if head >= ohead else 0.0


def sample(pids=None):
    """-> (rings, captures):
    rings:    {(pid, ring_name): (head_bytes, capacity_total, nringlet,
                                  backlog_frac)}
    captures: {(pid, name): (good_bytes, missing_bytes, invalid, late,
                             repeat)}
    """
    rings, captures = {}, {}
    for pid in (pids or list_pids(pipelines_only=True)):
        tree = load_by_pid(pid)
        for r in ring_metrics(tree):
            rings[(pid, r["name"])] = (r["head"], r["capacity_total"],
                                       r["nringlet"], r["backlog_frac"])
        for r in capture_metrics(tree):
            captures[(pid, r["name"])] = (r["good_bytes"],
                                          r["missing_bytes"],
                                          r["invalid"], r["late"],
                                          r["repeat"])
    return rings, captures


def draw(stdscr, interval, pids):
    stdscr.nodelay(True)
    prev_rings, prev_caps = sample(pids)
    prev_t = time.time()
    history = collections.defaultdict(
        lambda: collections.deque(maxlen=HISTORY))
    while True:
        if stdscr.getch() in (ord("q"), ord("Q")):
            return
        time.sleep(interval)
        rings, caps = sample(pids)
        now = time.time()
        dt = max(now - prev_t, 1e-6)
        stdscr.erase()
        maxy, maxx = stdscr.getmaxyx()
        y = 0

        def put(line, attr=curses.A_NORMAL):
            nonlocal y
            if y < maxy - 1:
                stdscr.addstr(y, 0, line[:maxx - 1], attr)
                y += 1

        put(f"like_bmon - {time.strftime('%H:%M:%S')} "
            f"(interval {interval:.1f}s, q quits)")
        put("")
        put(f"{'PID':>8} {'Rate MB/s':>10} {'Cap MB':>8} {'Backlog%':>8}"
            f"  {'History':<{HISTORY}}  Ring", curses.A_REVERSE)
        totals = collections.defaultdict(float)
        for key, (head, cap, nring, backlog) in sorted(rings.items()):
            pid, ring = key
            rate = _rate(prev_rings.get(key, (head,))[0], head, nring, dt)
            history[key].append(rate)
            totals[pid] += rate
            put(f"{pid:>8} {rate:>10.2f} {cap / 1e6:>8.1f} "
                f"{100 * backlog:>7.1f}%  "
                f"{sparkline(history[key]):<{HISTORY}}  {ring}")
        for pid in sorted(totals):
            put(f"{pid:>8} {totals[pid]:>10.2f} {'':>8} {'':>8}  "
                f"{'':<{HISTORY}}  TOTAL", curses.A_BOLD)
        if caps:
            put("")
            put(f"{'PID':>8} {'Good MB/s':>10} {'Miss MB/s':>10} "
                f"{'Inval':>6} {'Late':>6} {'Rept':>6}  Capture",
                curses.A_REVERSE)
            for key, (good, miss, inval, late, rept) in sorted(caps.items()):
                pid, name = key
                ogood, omiss = prev_caps.get(key, (good, miss))[:2]
                put(f"{pid:>8} {(good - ogood) / dt / 1e6:>10.2f} "
                    f"{(miss - omiss) / dt / 1e6:>10.2f} {inval:>6} "
                    f"{late:>6} {rept:>6}  {name}")
        stdscr.refresh()
        prev_rings, prev_caps, prev_t = rings, caps, now


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="bmon-style ring/capture rate monitor of "
                    "bifrost_tpu_torch pipelines")
    parser.add_argument("pids", type=int, nargs="*",
                        help="PIDs to watch (default: all live pipelines)")
    parser.add_argument("-i", "--interval", type=float, default=1.0,
                        help="poll interval in seconds")
    args = parser.parse_args(argv)
    if not sys.stdout.isatty():
        t0 = time.monotonic()
        rings, caps = sample(args.pids or None)
        if not rings and not caps:
            print("no live bifrost_tpu_torch pipelines found",
                  file=sys.stderr)
            return 1
        for key, val in sorted(rings.items()):
            print("ring", key, val)
        for key, val in sorted(caps.items()):
            print("capture", key, val)
        time.sleep(args.interval)
        later, _ = sample(args.pids or None)
        dt = max(time.monotonic() - t0, 1e-6)
        for key, (head, _cap, nring, _backlog) in sorted(later.items()):
            if key in rings and head >= rings[key][0]:
                print("rate", key,
                      f"{_rate(rings[key][0], head, nring, dt):.3f}")
        return 0
    curses.wrapper(draw, args.interval, args.pids or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
