"""Steady-state figures of the FRB and DQ chains of two checkouts, in
turns on one CUDA card: chip_smoke.py's `[main]` (the FRB search),
`[frbflag]` (the FRB search with the RFI flagger) and `[dq]` (the
flagged, calibrated beam search).

    python3 chain_ab.py OTHER_ROOT [--pairs N] [--chains main,frbflag,dq]

OTHER_ROOT is a second checkout of the repo (for example the parent
commit, unpacked with `git archive`).  Each turn is a fresh process that
builds that checkout's kernels and runs its own chip_smoke.py chains
twice, with their checks, and keeps the second run of each (the first
warms the process as chip_smoke.py's kernel phase does): `main_path` and
`frbflag_path` (the chains named; main and frbflag by default), and for
dq that checkout's `dq_chain` over `[dq]`'s voltages (`[bengine]`'s
seeded replay plus its tone, its seeded gains), timed as `dq_path` times
it (first to last integration out).  The turns go other, this, this,
other, ... for N pairs.  Prints each turn's steady-state frames/s, the
`[frbflag]` traced run's busy ms a gulp, idle share and top device ops
(the profiler's steady window, chip_smoke.py `ob_idle`), and the FDMT
block's host
seconds in `process` over the run (from chip_smoke.py's "host seconds by
block and phase" line, kept whole in the JSON); then, with main, in the
same process, one FRB gulp's `Fdmt.execute` alone: the host's
milliseconds to issue it, the card's for it, and a profile of the host's
time by function.  Last the card's name and power limit and a JSON
object of the figures by checkout and chain.
"""

import argparse
import json
import pathlib
import re
import subprocess
import sys

HEAD = ("import time, torch, numpy as np, chip_smoke as cs\n"
        "from bifrost_tpu_torch import build\n"
        "from bifrost_tpu_torch.ops import Fdmt\n"
        "build.build_all()\n"
        "dev = torch.device('cuda', 0)\n")

# [dq]'s chain as dq_path builds and times it, on the same voltages.
DQ = ("from bifrost_tpu_torch.blocks.testing import inject_tone\n"
      "rng = np.random.default_rng(cs.SEED)\n"
      "block = rng.integers(-8, 8, (cs.B_REPLAY * cs.B_GULP, cs.NSTAND, "
      "cs.NPOL, 2), dtype=np.int8)\n"
      "volt = np.concatenate([block] * (cs.B_NINT // cs.B_REPLAY) + "
      "[block[:cs.B_NINT % cs.B_REPLAY * cs.B_GULP]])\n"
      "del block\n"
      "inject_tone(volt, cs.DQ_TONE_INT * cs.B_GULP, cs.DQ_STATION, "
      "cs.DQ_CHAN, cs.BCHAN, cs.DQ_AMP)\n"
      "rng = np.random.default_rng(cs.SEED + 8)\n"
      "gains = (0.5 + rng.random(cs.NSTAND) + 0.3j * rng.standard_normal("
      "cs.NSTAND)).astype(np.complex64)\n"
      "def dq_steady():\n"
      "    got = {'beams': cs.Stamped(), 'dedispersed': []}\n"
      "    cs.dq_chain(dev, volt, gains, gather=got)[0].run()\n"
      "    torch.cuda.synchronize()\n"
      "    st = got['beams'].stamps\n"
      "    print(f'[dq] steady state '\n"
      "          f'{(len(st) - 1) * cs.B_GULP / (st[-1] - st[0]):.1f} '\n"
      "          f'frames/s', flush=True)\n")

CALLS = {"main": "cs.main_path(dev)", "frbflag": "cs.frbflag_path(dev)",
         "dq": "dq_steady()"}

FDMT = ("plan = Fdmt().init(cs.NCHAN, cs.MAX_DELAY, cs.F0, cs.DF, "
        "method='cuda')\n"
        "x = torch.randint(0, 256, (cs.NCHAN, cs.GULP + cs.MAX_DELAY), "
        "device=dev).float()\n"
        "for _ in range(3):\n"
        "    plan.execute(x)\n"
        "torch.cuda.synchronize()\n"
        "a, b = torch.cuda.Event(enable_timing=True), "
        "torch.cuda.Event(enable_timing=True)\n"
        "torch.cuda._sleep(1_000_000_000)\n"
        "a.record()\n"
        "t0 = time.perf_counter()\n"
        "for _ in range(20):\n"
        "    plan.execute(x)\n"
        "host = (time.perf_counter() - t0) / 20 * 1e3\n"
        "b.record()\n"
        "torch.cuda.synchronize()\n"
        "print(f'[fdmt] execute host {host:.4f} ms, card '\n"
        "      f'{a.elapsed_time(b) / 20:.4f} ms a gulp')\n"
        # Where the host's time to issue goes: the functions that take
        # the most of it, by their own time.
        "import cProfile, pstats\n"
        "prof = cProfile.Profile()\n"
        "prof.runcall(lambda: [plan.execute(x) for _ in range(20)])\n"
        "torch.cuda.synchronize()\n"
        "pstats.Stats(prof).sort_stats('tottime').print_stats(12)\n")


def program(chains):
    """The Python a turn runs for `chains`: each chain twice, in order;
    with main, the FDMT layer alone (it reads the card's time for one
    FRB gulp's execute while a sleep kernel queued first holds the card
    until the host is done)."""
    body = "".join(f"    {CALLS[c]}\n    cs.free_device()\n" for c in chains)
    return (HEAD + (DQ if "dq" in chains else "") +
            "for _ in range(2):\n" + body +
            (FDMT if "main" in chains else ""))


STEADY = re.compile(r"^\[(main|frbflag|dq)\] .*?steady state ([0-9.]+) "
                    r"frames/s", re.M)
BUSY = re.compile(r"^\[frbflag\] traced run .*? the card idle ([0-9.]+), "
                  r"busy ([0-9.]+) ms a gulp.*?top device ops, ms a gulp: "
                  r"(\[.*\]); host s by block", re.M)
LAYER = re.compile(r"^\[fdmt\] execute host ([0-9.]+) ms, card ([0-9.]+) ms",
                   re.M)
HOST = re.compile(r"^\[(main|frbflag)\] host seconds by block and phase: "
                  r"(\{.*\})$", re.M)
SERIAL = re.compile(r"_\d+$")   # a block's instance number


def turn(root, chains):
    """One process in `root` -> ({chain: fps}, {chain: {'block phase':
    host seconds}} for main and frbflag, each from its second run; the
    frbflag traced run's (idle share, busy ms a gulp, [[top device op,
    ms a gulp], ...]) or None; (host ms,
    card ms) of one FRB gulp's Fdmt.execute or None; the process's
    output)."""
    proc = subprocess.run([sys.executable, "-c", program(chains)],
                          cwd=root, capture_output=True, text=True,
                          timeout=1200)
    if proc.returncode:
        raise RuntimeError(f"{root}: rc {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    # The later match of each chain (its second run) wins.
    got = {k: float(v) for k, v in STEADY.findall(proc.stdout)}
    host = {k: {f"{SERIAL.sub('', blk)} {ph}": sec
                for blk, phases in json.loads(v).items()
                for ph, sec in phases.items()}
            for k, v in HOST.findall(proc.stdout)}
    busy = BUSY.findall(proc.stdout)
    layer = LAYER.search(proc.stdout)
    if set(got) != set(chains) or \
            set(host) != set(chains) & {"main", "frbflag"} or \
            ("main" in chains) != bool(layer) or \
            ("frbflag" in chains) != bool(busy):
        raise RuntimeError(f"{root}: no steady-state lines\n"
                           f"{proc.stdout[-3000:]}")
    return (got, host,
            (float(busy[-1][0]), float(busy[-1][1]), json.loads(busy[-1][2]))
            if busy else None,
            tuple(float(v) for v in layer.groups()) if layer else None,
            proc.stdout)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--chains", default="main,frbflag",
                    help="comma-separated chains of main, frbflag, dq")
    args = ap.parse_args()
    chains = [c for c in args.chains.split(",") if c]
    if not chains or set(chains) - set(CALLS):
        ap.error(f"--chains takes {', '.join(CALLS)}")
    here = pathlib.Path(__file__).resolve().parent
    roots = {"other": args.other.resolve(), "this": here}
    order = [("other", "this") if i % 2 == 0 else ("this", "other")
             for i in range(args.pairs)]
    figs = {name: {c: [] for c in chains} for name in roots}
    host_s = {name: {c: {} for c in chains if c != "dq"} for name in roots}
    traced = {name: {"idle": [], "busy_ms": [], "top_ms": []}
              for name in roots}
    execute = {name: {"host_ms": [], "card_ms": []} for name in roots}
    for pair in order:
        for name in pair:
            got, host, busy, layer, out = turn(roots[name], chains)
            for k in got:
                figs[name][k].append(got[k])
            for k in host:
                for key, sec in host[k].items():
                    host_s[name][k].setdefault(key, []).append(sec)
            line = ", ".join(f"{k} {got[k]:.1f}" for k in chains)
            if busy:
                traced[name]["idle"].append(busy[0])
                traced[name]["busy_ms"].append(busy[1])
                traced[name]["top_ms"].append(busy[2])
                line += (f" frames/s; frbflag traced: idle {busy[0]:.4f}, "
                         f"busy {busy[1]:.4f} ms a gulp, top device ops "
                         f"(ms a gulp) {json.dumps(busy[2])}")
            if layer:
                execute[name]["host_ms"].append(layer[0])
                execute[name]["card_ms"].append(layer[1])
                line += (f"; fdmt process {host['main']['fdmt process']:.4f}"
                         f" s; execute host {layer[0]:.4f}, card "
                         f"{layer[1]:.4f} ms")
            print(f"[turn] {name}: {line}", flush=True)
            if layer:
                print(out[out.index("ncalls"):], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"roots": {k: str(v) for k, v in roots.items()},
                      "steady_fps": figs, "host_s": host_s,
                      "frbflag_traced": traced,
                      "fdmt_execute_ms": execute}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
