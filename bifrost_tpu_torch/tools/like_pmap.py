"""like_pmap — memory-map style view of a bifrost_tpu_torch process's
ring buffers (the port's copy of tools/like_pmap.py, reading the tree
bifrost_tpu_torch writes; reference tools/like_pmap.py — per-ring
geometry with human sizes, per-space totals, watch mode).

For each ring: capacity, ghost-region size, ringlet count, memory space
('system', 'cuda_host' or 'cuda': the card's memory), live head position
and retained backlog, plus which block writes it and how many read it.
Totals are grouped by memory space, the number an operator needs when
sizing host RAM against device memory.

Usage: python -m bifrost_tpu_torch.tools.like_pmap [-v] [-i S] [pid ...]
"""

import argparse
import os
import sys
import time

from ..memory import SPACEMAP_INV
from ..proclog import load_by_pid, list_pids


def best_size(nbyte):
    """Human size with binary units (reference get_best_size parity)."""
    units = ["B", "KiB", "MiB", "GiB", "TiB"]
    value = float(nbyte)
    for unit in units:
        if value < 1024 or unit == units[-1]:
            return f"{value:7.1f} {unit}"
        value /= 1024.0
    return f"{value:7.1f} TiB"


def ring_rows(tree):
    """[(name, kv, writer, nreaders)] for every ring in the tree."""
    writers, readers = {}, {}
    for block, logs in tree.items():
        if block == "rings":
            continue
        for log, direction in (("out", writers), ("in", readers)):
            for key, val in logs.get(log, {}).items():
                if key.startswith("ring"):
                    if direction is writers:
                        writers[str(val)] = block
                    else:
                        readers[str(val)] = readers.get(str(val), 0) + 1
    rows = []
    for name, kv in sorted(tree.get("rings", {}).items()):
        if "capacity" not in kv:
            continue
        rows.append((name, kv, writers.get(name, "-"),
                     readers.get(name, 0)))
    return rows


def show(pid, verbose=False):
    """Print one process's ring map; -> False where it logged no ring."""
    tree = load_by_pid(pid)
    rows = ring_rows(tree)
    if not rows:
        print(f"pid {pid}: no rings logged")
        return False
    print(f"pid {pid}:")
    print(f"  {'RING':<44} {'SPACE':<7} {'CAPACITY':>11} {'GHOST':>11} "
          f"{'RL':>3} {'BACKLOG':>8} {'WRITER':<30} {'RD':>2}")
    totals = {}
    for name, kv, writer, nread in rows:
        cap_rl = int(kv.get("capacity", 0))  # bytes PER RINGLET
        nrl = int(kv.get("nringlet", 1))
        cap = cap_rl * nrl
        # the ghost region is mirrored per ringlet row (ring.py):
        # actual allocation is nringlet * (capacity + ghost)
        ghost = int(kv.get("ghost", 0)) * nrl
        space = kv.get("space", "?")
        space = SPACEMAP_INV.get(space, str(space))  # logged as a number
        totals[space] = totals.get(space, 0) + cap + ghost
        # head/guarantee are per-ringlet offsets (the ring log),
        # so backlog divides by the per-ringlet capacity, clamped — same
        # formula as proclog.ring_metrics.
        head = kv.get("reserve_head", kv.get("head", 0))
        tail = kv.get("guarantee", kv.get("tail", 0))
        backlog = (f"{min(100.0, max(0.0, 100.0 * (head - tail) / cap_rl)):6.1f}%"
                   if cap_rl else "     -")
        print(f"  {name:<44} {space:<7} {best_size(cap):>11} "
              f"{best_size(ghost):>11} {kv.get('nringlet', 1):>3} "
              f"{backlog:>8} {writer:<30} {nread:>2}")
        if verbose:
            extras = {k: v for k, v in sorted(kv.items())
                      if k not in ("capacity", "ghost", "nringlet", "space")}
            print(f"  {'':<44} {extras}")
    for space, nbyte in sorted(totals.items()):
        print(f"  {'TOTAL ' + space:<44} {'':<7} {best_size(nbyte):>11}")
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="ring-buffer memory map of live pipelines",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("pids", type=int, nargs="*",
                        help="PIDs to show (default: all live pipelines)")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="dump every logged key per ring")
    parser.add_argument("-i", "--interval", type=float, default=0.0,
                        help="watch mode: refresh every N seconds")
    args = parser.parse_args(argv)

    while True:
        pids = args.pids or list_pids(pipelines_only=True)
        if args.interval:
            os.system("clear")
        if not pids:
            print("no live bifrost_tpu_torch pipelines found",
                  file=sys.stderr)
            if not args.interval:
                return 1
        shown = [show(pid, verbose=args.verbose) for pid in pids]
        if not args.interval:
            return 0 if any(shown) else 1
        time.sleep(args.interval)


if __name__ == "__main__":
    sys.exit(main())
