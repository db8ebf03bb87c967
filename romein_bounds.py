"""Time the Romein gridders' parts apart on a CUDA card.

    python3 romein_bounds.py

Builds bifrost_tpu_torch/csrc/romein.cu five times (as the port builds
it; with ROMEIN_TAPS_GLOBAL, which reads every kernel tap from device
memory instead of a shared table or the chunk buffers; with
ROMEIN_SKIP_WALK, which stages every chunk but sums nothing; with
ROMEIN_SKIP_GATHER, which walks every chunk over data it never fetched;
with both) and times K6b (the default rank-1 kernel, taps from a table)
and K6a (chip_smoke's seeded per-visibility kernel, taps staged with
each chunk) on one frame of chip_smoke.py's imaging shapes: 4096 planes
x 262,144 visibilities, one complex64 every 16 bytes, onto 128 x 128.
The port's build and the taps-from-memory build must equal the plain
version; the others compute nothing meaningful.  Prints one line per
build and round and, last, the card's name and power limit and a JSON
object of the times.
"""

import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke as cs
from bifrost_tpu_torch import build
from bifrost_tpu_torch.ops import Romein, romein_kernel
from bifrost_tpu_torch.service import default_grid_kernel, default_uvw

BUILDS = {"kernel": (), "taps from memory": ("ROMEIN_TAPS_GLOBAL",),
          "gather only": ("ROMEIN_SKIP_WALK",),
          "walk only": ("ROMEIN_SKIP_GATHER",),
          "neither": ("ROMEIN_SKIP_WALK", "ROMEIN_SKIP_GATHER")}


def compile_all(out_dir):
    """One nvcc per build, all at once -> {name: library path}."""
    src = build.CSRC / "romein.cu"
    procs = {}
    for name, defs in BUILDS.items():
        lib = out_dir / f"libromein-{name.replace(' ', '_')}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS,
               *(f"-D{d}" for d in defs), "-o", str(lib), str(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        print("romein_bounds: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out_dir = build.BUILD_DIR / "bounds"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = compile_all(out_dir)
    npol, nvis = cs.BCHAN, (cs.NSTAND * cs.NPOL) ** 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    raw = torch.randn(npol, nvis, 2, 2, device=dev, generator=gen)
    data = torch.view_as_complex(raw)[..., 0]
    uvw = default_uvw(cs.NSTAND, cs.NPOL, cs.NGRID, cs.M_KERN)
    plans = {"K6b": default_grid_kernel(cs.M_KERN),
             "K6a": cs.k6a_kernels(nvis)}
    plans = {k: Romein().init(uvw, v, cs.NGRID).plan(npol, nvis, dev)[0]
             for k, v in plans.items()}
    out = torch.empty(npol, cs.NGRID, cs.NGRID, dtype=torch.complex64,
                      device=dev)
    want = {k: p.grid(data, torch.empty_like(out), "plain", False)
            for k, p in plans.items()}
    times = {}
    for rnd in range(2):
        for name, lib in libs.items():
            romein_kernel._lib = romein_kernel._declare(
                ctypes.CDLL(str(lib)))
            for k, plan in plans.items():
                ms = cs.cuda_time(
                    lambda: plan.grid(data, out, "cuda", False), 10)
                equal = cs.bits_equal(torch.view_as_real(out),
                                      torch.view_as_real(want[k]))
                if name in ("kernel", "taps from memory") and not equal:
                    raise AssertionError(f"{k} differs from plain")
                times.setdefault(k, {}).setdefault(name, []).append(ms)
                print(f"[bounds] round {rnd} {k} {name}: {ms:.4f} ms",
                      flush=True)
    romein_kernel._lib = None
    print(smi)
    print(json.dumps({"kind": kind, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
