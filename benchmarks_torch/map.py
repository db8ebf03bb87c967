#!/usr/bin/env python3
"""bf.map benchmark of the PyTorch/CUDA port and its fast self-check (the
port's copy of benchmarks/map_tpu.py).

Measures the planned map op (ops/map.py: the mini-language as kernel M1,
one CUDA kernel generated per expression) standalone at the JAX
defaults (`--ntime 16384 --ncell 256`, complex64) —
`map_samples_per_sec`, beside the plain PyTorch engine's — and as a
chain, copy('cuda') -> map -> detect(scalar), fused (one group, the map
a member) and unfused, reps interleaved, the best of each kept.

Usage:
    python benchmarks_torch/map.py                       # on the card
    python benchmarks_torch/map.py --ntime 65536 --ncell 512
    python benchmarks_torch/map.py --check --device cpu

The op and the chain run on the card unless `--device cpu` is given.
`--check` is the fast self-check on the plain engine: the mini-language
goldens (scalars, ternary, multi-statement, sqrt), fused against unfused
bitwise on the chain (a partial final gulp, raw ci8 ingest), the
stencil's split gulps against one long gulp, the map_unbounded_index
refusal, the plan report, a numpy array bound as a scalar; no timing.  Prints ONE JSON line (map_*
fields).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAP_FUNC = "y = 2.0f*x*x.conj() + 1.0f"
STENCIL = "y(t,c,s) = x(t,c,s) - x(t-1,c,s)"
STENCIL_AXES = ("t", "c", "s")


def make_stream(nframe, nchan=8, nstation=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nframe, nchan, nstation)) +
            1j * rng.standard_normal((nframe, nchan, nstation))
            ).astype(np.complex64)


def make_ci8(nframe, nchan=8, nstation=4, seed=0):
    """ci8 voltages in the port's storage form (a trailing (re, im))."""
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (nframe, nchan, nstation, 2)) \
        .astype(np.int8)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_op_slope(dev, ntime, ncell, reps, method=None):
    """Best-of samples/s of the planned op on a complex64 (ntime, ncell)
    array on `dev`."""
    import torch
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((ntime, ncell)) +
                          1j * rng.standard_normal((ntime, ncell)))
                         .astype(np.complex64)).to(dev)
    op = Map(MAP_FUNC, method=method)
    op.execute(x)                        # build + warm
    _sync(dev)
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        op.execute(x)
        _sync(dev)
        best = max(best, ntime * ncell / (time.perf_counter() - t0))
    return best, op.plan_report()["method"]


def run_chain(dev, data, hdr_dtype, fuse_on, gulp=64, func=MAP_FUNC,
              axis_names=None, collect=None, report_out=None):
    """One copy -> map -> detect pipeline run -> samples/s."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import blocks, config
    from bifrost_tpu_torch.blocks.testing import array_source, callback_sink
    from bifrost_tpu_torch.pipeline import Pipeline
    config.set("pipeline_fuse", bool(fuse_on))
    nsamp = int(np.prod(data.shape[:3]))
    try:
        with Pipeline(device=dev) as pipe:
            src = array_source(data, gulp, header={
                "dtype": hdr_dtype, "labels": ["time", "freq", "station"]})
            with bt.block_scope(fuse=True):
                d = blocks.copy(src, space="cuda")
                m = blocks.map_block(d, func, axis_names=axis_names)
                det = blocks.detect(m, mode="scalar")
            callback_sink(det, on_data=(
                (lambda a: collect.append(a.cpu().numpy().copy()))
                if collect is not None else None))
            t0 = time.perf_counter()
            pipe.run()
            _sync(dev)
            dt = time.perf_counter() - t0
            if report_out is not None:
                report_out.append(pipe.fusion_report())
        return nsamp / dt
    finally:
        config.reset("pipeline_fuse")


def measure(args, dev):
    import statistics
    import torch
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rate, method = run_op_slope(dev, args.ntime, args.ncell, args.reps)
    plain, _ = run_op_slope(dev, args.ntime, args.ncell, args.reps,
                            method="plain")
    out = {"map_device": kind, "map_method": method,
           "map_samples_per_sec": rate,
           "map_plain_samples_per_sec": plain}
    data = make_stream(args.nframe)
    run_chain(dev, data, "cf32", True)           # builds and warms
    run_chain(dev, data, "cf32", False)
    ratios, reports = [], []
    best = {"fused": 0.0, "unfused": 0.0}
    for _ in range(args.reps):                   # interleaved, best-of
        rf = run_chain(dev, data, "cf32", True, report_out=reports)
        ru = run_chain(dev, data, "cf32", False)
        best["fused"] = max(best["fused"], rf)
        best["unfused"] = max(best["unfused"], ru)
        ratios.append(rf / ru)
    rep = reports[-1]
    out.update({
        "map_fused_chain_samples_per_sec": best["fused"],
        "map_unfused_chain_samples_per_sec": best["unfused"],
        "map_fused_chain_speedup": best["fused"] / best["unfused"],
        "map_fused_chain_speedup_min": min(ratios),
        "map_fused_chain_speedup_median": statistics.median(ratios),
        "map_fused_chain_speedup_max": max(ratios),
        "map_fused_chain_speedup_reps": len(ratios),
        "map_fusion_ring_hops_eliminated": rep["ring_hops_eliminated"],
        "map_fusion_rules": sorted({g["rule"] for g in rep["groups"]}),
    })
    print(json.dumps(out))
    return 0


# --------------------------------------------------------------- --check
def _check_translator_goldens(failures, dev):
    import torch
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(7)
    x = rng.standard_normal((32, 5)).astype(np.float32)
    cases = [
        ("y = s*x + 1.0f", dict(scalars={"s": 2.5}),
         (2.5 * x + 1.0).astype(np.float32)),
        ("y = x > 0 ? x : -x", {}, np.abs(x)),
        ("p = x*x; y = p + p", {}, (x * x + x * x).astype(np.float32)),
        ("y = sqrt(fabs(x))", {}, np.sqrt(np.abs(x)).astype(np.float32)),
    ]
    for func, kw, golden in cases:
        got = Map(func, **kw).execute(torch.from_numpy(x).to(dev))
        if not np.allclose(got.cpu().numpy(), golden, rtol=1e-6,
                           atol=1e-6):
            failures.append(f"map translator golden failed: {func!r}")


def _check_fused_parity(failures, dev):
    for nframe, make, hdr in ((128, make_stream, "cf32"),
                              (115, make_stream, "cf32"),
                              (96, make_ci8, "ci8")):
        data = make(nframe, seed=nframe)
        reports, got_f, got_u = [], [], []
        run_chain(dev, data, hdr, True, gulp=32, collect=got_f,
                  report_out=reports)
        run_chain(dev, data, hdr, False, gulp=32, collect=got_u)
        f, u = np.concatenate(got_f), np.concatenate(got_u)
        if f.shape != u.shape or not np.array_equal(f, u):
            failures.append(f"fused vs unfused map chain differ at "
                            f"nframe={nframe} dtype={hdr}")
        names = [n for g in reports[-1]["groups"] for n in g["constituents"]]
        if not any("MapBlock" in n for n in names):
            failures.append(f"map stage not fused: {reports[-1]}")


def _check_stencil_carry(failures, dev):
    data = make_stream(115, seed=3)
    d = data - np.concatenate([np.zeros_like(data[:1]), data[:-1]])
    golden = (d * d.conj()).real.astype(np.float32)
    runs = {}
    for tag, fuse_on, gulp in (("long", False, 115), ("split", False, 16),
                               ("fused", True, 16)):
        got, reports = [], []
        run_chain(dev, data, "cf32", fuse_on, gulp=gulp, func=STENCIL,
                  axis_names=STENCIL_AXES, collect=got, report_out=reports)
        runs[tag] = np.concatenate(got)
        if tag == "fused" and not any(g["rule"] == "stateful_chain"
                                      for g in reports[-1]["groups"]):
            failures.append(f"stencil map did not form a stateful_chain: "
                            f"{reports[-1]}")
    if not np.array_equal(runs["long"], runs["split"]):
        failures.append("stencil split-gulp carry broke bitwise continuity")
    if not np.array_equal(runs["long"], runs["fused"]):
        failures.append("fused stencil chain != unfused long gulp")
    if not np.allclose(runs["long"], golden, rtol=1e-5, atol=1e-5):
        failures.append("stencil output != zero-history golden")


def _check_refusal(failures, dev):
    from bifrost_tpu_torch.fuse import REASONS
    if "map_unbounded_index" not in REASONS:
        failures.append("map_unbounded_index not a refusal reason")
    data = make_stream(64, seed=5)
    reports, got_f, got_u = [], [], []
    func = "y(t,c,s) = x(nt-1-t,c,s)"
    run_chain(dev, data, "cf32", True, gulp=16, func=func,
              axis_names=STENCIL_AXES, collect=got_f, report_out=reports)
    run_chain(dev, data, "cf32", False, gulp=16, func=func,
              axis_names=STENCIL_AXES, collect=got_u)
    reasons = {n: r for n, r in reports[-1]["refused"].items()
               if "MapBlock" in n}
    if list(reasons.values()) != ["map_unbounded_index"]:
        failures.append(f"unbounded map refusal wrong: {reasons}")
    if not np.array_equal(np.concatenate(got_f), np.concatenate(got_u)):
        failures.append("refused map stage not deterministic per gulp")


def _check_plan_report(failures, dev):
    import torch
    from bifrost_tpu_torch.ops.map import Map, _compile_map, \
        _FN_CACHE_CAPACITY
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (64, 6)).astype(np.float32)).to(dev)
    op = Map("y = x*x")
    op.execute(x)
    op.execute(x)
    rep = op.plan_report()
    # 'auto' runs M1 on the card and the plain engine on the CPU.
    want = "cuda" if torch.device(dev).type == "cuda" else "plain"
    if rep["op"] != "map" or rep["method"] != want or \
            rep["codegen_refusal"] is not None:
        failures.append(f"map plan report op/method wrong: {rep}")
    if rep["cache"]["misses"] < 1 or rep["cache"]["hits"] < 1:
        failures.append(f"map plan cache accounting wrong: {rep['cache']}")
    if _compile_map.cache_info().maxsize != 64 or _FN_CACHE_CAPACITY != 64:
        failures.append("map caches are not the 64-entry LRUs")
    try:
        Map("y = x", method="bogus")
        failures.append("bogus map method accepted")
    except ValueError:
        pass


def _check_numpy_scalar(failures, dev):
    """A numpy array bound as a scalar (a constant array), at
    construction and by set_scalars, against the exact numpy product."""
    import torch
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(13)
    x = rng.integers(-64, 64, (48, 5)).astype(np.float32)
    w = rng.integers(-8, 8, 5).astype(np.float32)
    op = Map("y = x * w + 1", scalars={"w": w})
    xt = torch.from_numpy(x).to(dev)
    for want in (x * w + 1, None):
        if want is None:
            w2 = (w * 3).astype(np.float32)
            op.set_scalars({"w": w2})
            want = x * w2 + 1
        got = op.execute(xt).cpu().numpy()
        if got.dtype != np.float32 or not np.array_equal(got, want):
            failures.append("map numpy-array scalar differs from numpy")


def run_check(dev):
    failures = []
    for check in (_check_translator_goldens, _check_fused_parity,
                  _check_stencil_carry, _check_refusal, _check_plan_report,
                  _check_numpy_scalar):
        check(failures, dev)
    for f in failures:
        print(f"map --check: {f}", file=sys.stderr)
    print(json.dumps({"map_check": "ok" if not failures else "FAIL",
                      "failures": len(failures)}))
    return 1 if failures else 0


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ntime", type=int, default=1 << 14)
    p.add_argument("--ncell", type=int, default=256)
    p.add_argument("--nframe", type=int, default=768)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    p.add_argument("--check", action="store_true",
                   help="fast self-check: goldens, fused parity, stencil "
                        "carry, refusal, plan report; no timing")
    args = p.parse_args()
    from bifrost_tpu_torch.device import resolve_device, set_device
    dev = resolve_device(args.device)
    set_device(dev)
    if args.check:
        return run_check(dev)
    return measure(args, dev)


if __name__ == "__main__":
    sys.exit(main())
