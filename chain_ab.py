"""Steady-state frames/s of the FRB chains of two checkouts, in turns on
one CUDA card: chip_smoke.py's `[main]` (the FRB search) and `[frbflag]`
(the FRB search with the RFI flagger).

    python3 chain_ab.py OTHER_ROOT [--pairs N]

OTHER_ROOT is a second checkout of the repo (for example the parent
commit, unpacked with `git archive`).  Each turn is a fresh process that
builds that checkout's kernels and runs its own chip_smoke.py
`main_path` and `frbflag_path` twice, with their checks, and keeps the
second run of each (the first warms the process as chip_smoke.py's
kernel phase does).  The turns go other, this, this, other, ... for N
pairs.  Prints each turn's steady-state figures and the FDMT block's
host seconds in `process` over the run (from chip_smoke.py's "host
seconds by block and phase" line, kept whole in the JSON); then, in the
same process, one FRB gulp's `Fdmt.execute` alone: the host's
milliseconds to issue it, the card's for it, and a profile of the
host's time by function.  Last the card's name and power limit and a
JSON object of the figures by checkout and chain.
"""

import argparse
import json
import pathlib
import re
import subprocess
import sys

RUN = ("import time, torch, chip_smoke as cs\n"
       "from bifrost_tpu_torch import build\n"
       "from bifrost_tpu_torch.ops import Fdmt\n"
       "build.build_all()\n"
       "dev = torch.device('cuda', 0)\n"
       "for _ in range(2):\n"
       "    cs.main_path(dev)\n"
       "    cs.free_device()\n"
       "    cs.frbflag_path(dev)\n"
       "    cs.free_device()\n"
       # The FDMT layer alone on one FRB gulp: the host's time to issue
       # an execute, and the card's time for it, read while a sleep
       # kernel queued first holds the card until the host is done.
       "plan = Fdmt().init(cs.NCHAN, cs.MAX_DELAY, cs.F0, cs.DF, "
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

STEADY = re.compile(r"^\[(main|frbflag)\] .*?steady state ([0-9.]+) "
                    r"frames/s", re.M)
LAYER = re.compile(r"^\[fdmt\] execute host ([0-9.]+) ms, card ([0-9.]+) ms",
                   re.M)
HOST = re.compile(r"^\[(main|frbflag)\] host seconds by block and phase: "
                  r"(\{.*\})$", re.M)
SERIAL = re.compile(r"_\d+$")   # a block's instance number


def turn(root):
    """One process in `root` -> ({'main': fps, 'frbflag': fps}, the same
    keys to {'block phase': host seconds}, each from its second run;
    (host ms, card ms) of one FRB gulp's Fdmt.execute; the process's
    output)."""
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"{root}: rc {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    # The later match of each chain (its second run) wins.
    got = {k: float(v) for k, v in STEADY.findall(proc.stdout)}
    host = {k: {f"{SERIAL.sub('', blk)} {ph}": sec
                for blk, phases in json.loads(v).items()
                for ph, sec in phases.items()}
            for k, v in HOST.findall(proc.stdout)}
    layer = LAYER.search(proc.stdout)
    if set(got) != {"main", "frbflag"} or set(host) != set(got) or \
            not layer:
        raise RuntimeError(f"{root}: no steady-state lines\n"
                           f"{proc.stdout[-3000:]}")
    return got, host, tuple(float(v) for v in layer.groups()), proc.stdout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    here = pathlib.Path(__file__).resolve().parent
    roots = {"other": args.other.resolve(), "this": here}
    order = [("other", "this") if i % 2 == 0 else ("this", "other")
             for i in range(args.pairs)]
    figs = {name: {"main": [], "frbflag": []} for name in roots}
    host_s = {name: {"main": {}, "frbflag": {}} for name in roots}
    execute = {name: {"host_ms": [], "card_ms": []} for name in roots}
    for pair in order:
        for name in pair:
            got, host, layer, out = turn(roots[name])
            for k in got:
                figs[name][k].append(got[k])
                for key, sec in host[k].items():
                    host_s[name][k].setdefault(key, []).append(sec)
            execute[name]["host_ms"].append(layer[0])
            execute[name]["card_ms"].append(layer[1])
            print(f"[turn] {name}: main {got['main']:.1f}, frbflag "
                  f"{got['frbflag']:.1f} frames/s; fdmt process "
                  f"{host['main']['fdmt process']:.4f} / "
                  f"{host['frbflag']['fdmt process']:.4f} s; execute host "
                  f"{layer[0]:.4f}, card {layer[1]:.4f} ms", flush=True)
            print(out[out.index("ncalls"):], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"roots": {k: str(v) for k, v in roots.items()},
                      "steady_fps": figs, "host_s": host_s,
                      "fdmt_execute_ms": execute}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
