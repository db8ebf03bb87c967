"""Time the B-engine K4 and the masked fill K5a against variants of their
sources on a CUDA card.

    python3 kernel_variants.py [--rounds N]

Each variant is the port's source (bifrost_tpu_torch/csrc/beamform.cu or
dq.cu) with a few lines replaced (VARIANTS below: every replaced text
must occur exactly once), compiled with the port's nvcc flags into
bifrost_tpu_torch/build/variants/, one nvcc each, all at once.  Every
variant runs through the port's own wrapper (its library and, for K4,
its geometry constants swapped in), is held bitwise against the plain
version, and is timed by CUDA events on chip_smoke.py's shapes: K4 on
one beam-search gulp (16 x 4096 x 512 complex64, 8 beams); K5a on
[frbflag]'s gulp (4096 x 4096 f32, windows of 16) and [dq]'s (16 x
2,097,152 complex64, one window).  torch.matmul and torch.where are
timed in the same rounds.  Prints each variant's registers and shared
memory from ptxas, one line per round, and last the card's name and
power limit and a JSON object of the times (ms).
"""

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys

import torch

import chip_smoke as cs
from bifrost_tpu_torch import build
from bifrost_tpu_torch.ops import beamform_kernel as bk
from bifrost_tpu_torch.ops import dq_kernel as dk

# name -> (source, [(text, replacement), ...]); "as built" first.
VARIANTS = {
    "K4 as built": ("beamform", []),
    "K4 first design": ("beamform", [
        ("kRows = 256;", "kRows = 128;"),
        ("kRowBytes = 128;", "kRowBytes = 256;"),
        ("kStages = 2;", "kStages = 3;"),
        ("#pragma unroll\n                for (int q = 0;",
         "#pragma unroll 4\n                for (int q = 0;")]),
    "K4 128 rows": ("beamform", [("kRows = 256;", "kRows = 128;")]),
    "K4 64 rows": ("beamform", [("kRows = 256;", "kRows = 64;")]),
    "K4 3 stages": ("beamform", [("kStages = 2;", "kStages = 3;")]),
    "K4 256-byte rows": ("beamform", [
        ("kRowBytes = 128;", "kRowBytes = 256;")]),
    "K4 256-byte rows 3 stages": ("beamform", [
        ("kRowBytes = 128;", "kRowBytes = 256;"),
        ("kStages = 2;", "kStages = 3;")]),
    "K4 3 blocks an SM": ("beamform", [
        ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")]),
    "K4 2 rows a thread": ("beamform", [
        ("kRowsPerThread = 1;", "kRowsPerThread = 2;")]),
    "K4 pieces unrolled by 4": ("beamform", [(
        "#pragma unroll\n                for (int q = 0;",
        "#pragma unroll 4\n                for (int q = 0;")]),
    "K4 pieces not unrolled": ("beamform", [(
        "#pragma unroll\n                for (int q = 0;",
        "#pragma unroll 1\n                for (int q = 0;")]),
    "K5a as built": ("dq", []),
    "K5a scalar kernel": ("dq", [
        ("    if (vec) {\n", "    if (false) {\n")]),
    "K5a evict-first": ("dq", [("{ return *p; }", "{ return __ldcs(p); }"),
                               ("{ *p = v; }", "{ __stcs(p, v); }")]),
    "K5a 2 in flight": ("dq", [("kUnroll = 4;", "kUnroll = 2;")]),
    "K5a 8 in flight": ("dq", [("kUnroll = 4;", "kUnroll = 8;")]),
    "K5a 128 threads": ("dq", [("kThreads = 256;", "kThreads = 128;")]),
}


def compile_all(out_dir):
    """One nvcc per variant, all at once -> {name: (library, ptxas)}."""
    procs = {}
    for i, (name, (src, subs)) in enumerate(VARIANTS.items()):
        text = (build.CSRC / f"{src}.cu").read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} occurs "
                                   f"{text.count(old)} times in {src}.cu")
            text = text.replace(old, new)
        cu = out_dir / f"v{i}_{src}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
    return out


@contextlib.contextmanager
def swapped(name, lib):
    """The port's wrapper of `name`'s kernel running `lib` (and, for K4,
    that build's geometry constants)."""
    src, subs = VARIANTS[name]
    mod = bk if src == "beamform" else dk
    saved = {k: getattr(mod, k) for k in
             ("_lib", "ROWS", "GROUP", "MAX_BEAMS", "ROW_BYTES", "STAGES")
             if hasattr(mod, k)}
    load = build.load
    build.load = lambda _: ctypes.CDLL(str(lib))
    try:
        mod._lib = None
        mod._library()
        if mod is bk:
            text = (lib.with_suffix(".cu")).read_text()
            val = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
            bk.ROWS, bk.ROW_BYTES, bk.STAGES = (
                int(val[k]) for k in ("kRows", "kRowBytes", "kStages"))
        yield
    finally:
        build.load = load
        for k, v in saved.items():
            setattr(mod, k, v)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = compile_all(out_dir)
    for name, (_, ptxas) in libs.items():
        print(f"[ptxas] {name}: {ptxas}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    shape = (cs.N_INT, cs.BCHAN, cs.NSTAND * cs.NPOL)
    x = torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)
    w = torch.randn(cs.NBEAM, shape[2], dtype=torch.complex64, device=dev,
                    generator=gen)
    pout = torch.empty(cs.NBEAM, cs.BCHAN, device=dev)
    pwant = bk.beamform_power_plain(x, w)
    xp, wt = x.permute(1, 0, 2).contiguous(), w.T.contiguous()
    ncell = cs.BCHAN * cs.NSTAND * cs.NPOL
    fills = {
        "frb": (torch.randn(cs.GULP, cs.NCHAN, device=dev, generator=gen),
                torch.rand(cs.GULP // 16, cs.NCHAN, device=dev,
                           generator=gen) < 0.05, 16),
        "dq": (torch.randn(cs.N_INT, ncell, dtype=torch.complex64,
                           device=dev, generator=gen),
               torch.rand(1, ncell, device=dev, generator=gen) < 0.05,
               cs.DQ_WINDOW)}
    fwant = {k: dk.masked_fill_plain(*v[:2], None, v[2])
             for k, v in fills.items()}
    fout = {k: torch.empty_like(v[0]) for k, v in fills.items()}
    lib_fill = {}
    for k, (fx, fm, win) in fills.items():
        mw = fm.view(fm.shape[0], 1, -1)
        xw = fx.view(fm.shape[0], win if k == "frb" else fx.shape[0], -1)
        zero = torch.zeros((), dtype=fx.dtype, device=dev)
        lib_fill[k] = (lambda mw=mw, xw=xw, zero=zero:
                       torch.where(mw, zero, xw))

    times = {}
    for rnd in range(args.rounds):
        row = {"torch.matmul": cs.cuda_time(lambda: torch.matmul(xp, wt),
                                            10)}
        for k, f in lib_fill.items():
            row[f"torch.where {k}"] = cs.cuda_time(f, 20)
        for name, (lib, _) in libs.items():
            with swapped(name, lib):
                if VARIANTS[name][0] == "beamform":
                    bk.beamform_power(x, w, out=pout)
                    torch.cuda.synchronize()
                    if not cs.bits_equal(pout, pwant):
                        raise AssertionError(f"{name} differs from plain")
                    row[name] = cs.cuda_time(
                        lambda: bk.beamform_power(x, w, out=pout), 20)
                    continue
                for k, (fx, fm, win) in fills.items():
                    dk.masked_fill(fx, fm, None, win, out=fout[k])
                    torch.cuda.synchronize()
                    a, b = (torch.view_as_real(t) if t.is_complex() else t
                            for t in (fout[k], fwant[k]))
                    if not cs.bits_equal(a, b):
                        raise AssertionError(f"{name} differs from plain "
                                             f"({k})")
                    row[f"{name} {k}"] = cs.cuda_time(
                        lambda: dk.masked_fill(fx, fm, None, win,
                                               out=fout[k]), 20)
        print(f"[round {rnd}] " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in row.items()),
              flush=True)
        for k, v in row.items():
            times.setdefault(k, []).append(v)
    print(smi)
    print(json.dumps({"device": kind, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
