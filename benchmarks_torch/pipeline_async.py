#!/usr/bin/env python3
"""Async gulp executor benchmark of the PyTorch/CUDA port: serialized
against sync against async throughput (the port's copy of
benchmarks/pipeline_async.py).

Runs the capture -> unpack -> correlate chain (a packed ci4 capture
stream, the host unpack to ci8, the H2D copy, the int8 X-engine, kernel
X1 on the card) under three executor disciplines, reps interleaved,
the best of each kept, with the per-block stall map (the share of a
block's host seconds spent in acquire and reserve, from
`Block.perf_totals`):

- serialized — every gulp of every block reserve -> compute -> commit,
  synchronised, one block's device scope at a time (`strict_sync` +
  `serialize_dispatch`);
- sync — `pipeline_async_depth` 1: the blocks pipeline across their
  threads, each block's own ring work still gating its device calls;
- async — `--depth`: the executor, gulp N+1's ring work and H2D staging
  under gulp N's device work.

Two knobs emulate a slow transport with GIL-released sleeps, as the JAX
harness's do: `--dispatch-latency MS` in the device blocks' on_data and
`--ring-latency MS` on every nonzero-frame acquire/reserve of a 'cuda'
ring.

Usage:
    python benchmarks_torch/pipeline_async.py                  # on the card
    python benchmarks_torch/pipeline_async.py --depth 8 --gulp 128
    python benchmarks_torch/pipeline_async.py --ring-latency 10 \\
        --dispatch-latency 10
    python benchmarks_torch/pipeline_async.py --check --device cpu

The chain runs on the card unless `--device cpu` is given.  `--check`
is the fast self-check: at a tiny geometry the three disciplines'
outputs bitwise equal to each other and to the exact numpy golden, and
the overlap invariant (the block thread reserves ahead of a held
worker); no timing.  Prints ONE JSON line (pipeline_async_* fields).
"""

import argparse
import contextlib
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HDR = {"dtype": "ci4", "labels": ["time", "freq", "station", "pol"]}


def make_capture(ntime, nchan, nstand, npol, seed=0):
    """A packed ci4 voltage stream (the real part in the high nibble)
    and its exact complex64 value."""
    rng = np.random.default_rng(seed)
    re = rng.integers(-7, 8, (ntime, nchan, nstand, npol))
    im = rng.integers(-7, 8, (ntime, nchan, nstand, npol))
    packed = ((re & 0xF).astype(np.uint8) << 4) | (im & 0xF).astype(np.uint8)
    return packed, (re + 1j * im).astype(np.complex64)


def _add_dispatch_latency(block, seconds):
    """A GIL-released sleep after each of the block's gulps."""
    real = block.on_data

    def delayed(*a, **k):
        r = real(*a, **k)
        time.sleep(seconds)
        return r
    block.on_data = delayed


@contextlib.contextmanager
def ring_latency(seconds):
    """A GIL-released sleep on every nonzero-frame acquire and reserve of
    a 'cuda' ring (zero-frame reserves map no span and stay free), for
    one run."""
    from bifrost_tpu_torch import ring as _ring
    if not seconds:
        yield
        return
    real_reserve = _ring.WriteSequence.reserve
    real_acquire = _ring.ReadSequence.acquire

    def reserve(seq, nframe, nonblocking=False):
        span = real_reserve(seq, nframe, nonblocking)
        if nframe > 0 and seq.ring.space == "cuda":
            time.sleep(seconds)
        return span

    def acquire(seq, frame_offset, nframe, nonblocking=False):
        span = real_acquire(seq, frame_offset, nframe, nonblocking)
        if nframe > 0 and seq.ring.space == "cuda":
            time.sleep(seconds)
        return span

    _ring.WriteSequence.reserve = reserve
    _ring.ReadSequence.acquire = acquire
    try:
        yield
    finally:
        _ring.WriteSequence.reserve = real_reserve
        _ring.ReadSequence.acquire = real_acquire


@contextlib.contextmanager
def discipline(name, depth):
    """The flags of one executor discipline ('serialized', 'sync' or
    'async' at `depth`) for one run."""
    from bifrost_tpu_torch import config
    flags = {"pipeline_async_depth": depth if name == "async" else 1}
    if name == "serialized":
        flags.update(strict_sync=True, serialize_dispatch=True)
    for k, v in flags.items():
        config.set(k, v)
    try:
        yield
    finally:
        for k in flags:
            config.reset(k)


def stall_map(pipe):
    """Percent of each block's host seconds spent waiting in acquire and
    reserve."""
    out = {}
    for b in pipe.blocks:
        pt = dict(b.perf_totals)
        tot = sum(pt.values())
        if tot > 0:
            out[b.name] = round(100.0 * (pt.get("acquire", 0.0) +
                                         pt.get("reserve", 0.0)) / tot, 2)
    return out


def run_chain(host_ci4, mode, depth, gulp, n_int, device, latency_s=0.0,
              ring_latency_s=0.0, collect=None):
    """One timed run under discipline `mode` -> (samples/s, stall map,
    the executor depth each block ran)."""
    import torch
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import array_source, callback_sink
    from bifrost_tpu_torch.pipeline import Pipeline

    ntime, nchan, nstand, npol = host_ci4.shape
    with discipline(mode, depth), ring_latency(ring_latency_s), \
            Pipeline(device=device) as pipe:
        src = array_source(host_ci4, gulp, header=dict(HDR), name="capture")
        u = blocks.unpack(src, name="unpack")
        dev = blocks.copy(u, space="cuda", name="h2d")
        cor = blocks.correlate(dev, n_int, engine="int8", name="xengine")
        if latency_s > 0:
            _add_dispatch_latency(dev, latency_s)
            _add_dispatch_latency(cor, latency_s)
        if collect is not None:
            back = blocks.copy(cor, space="system", name="d2h")
            callback_sink(back, name="sink",
                          on_data=lambda d: collect.append(d.numpy().copy()))
        else:
            # The visibilities stay on the card (a device sink).
            callback_sink(cor, name="sink")
        t0 = time.perf_counter()
        pipe.run()
        if torch.device(pipe.device).type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    depths = {b.name: b._exec_async_depth for b in pipe.blocks}
    return ntime * nchan * nstand * npol / dt, stall_map(pipe), depths


def measure(args):
    host, _ = make_capture(args.ntime, args.nchan, args.nstand, args.npol)
    lat = args.dispatch_latency * 1e-3
    rlat = args.ring_latency * 1e-3
    modes = ("serialized", "sync", "async")
    for mode in modes[1:]:        # warm the kernels outside the timing
        run_chain(host, mode, args.depth, args.gulp, args.n_int,
                  args.device)
    best = {m: 0.0 for m in modes}
    stall = {m: {} for m in modes}
    depths = {}
    for _ in range(args.reps):    # interleaved, best of
        for mode in modes:
            r, st, d = run_chain(host, mode, args.depth, args.gulp,
                                 args.n_int, args.device, lat, rlat)
            depths[mode] = d
            if r > best[mode]:
                best[mode], stall[mode] = r, st
    print(json.dumps({
        "pipeline_serialized_samples_per_sec": best["serialized"],
        "pipeline_sync_samples_per_sec": best["sync"],
        "pipeline_async_samples_per_sec": best["async"],
        "pipeline_async_speedup": best["async"] / best["sync"],
        "pipeline_async_vs_serialized_speedup":
            best["async"] / best["serialized"],
        "pipeline_async_depth": args.depth,
        "dispatch_latency_ms": args.dispatch_latency,
        "ring_latency_ms": args.ring_latency,
        "stall_pct_by_block_serialized": stall["serialized"],
        "stall_pct_by_block_sync": stall["sync"],
        "stall_pct_by_block_async": stall["async"],
        "executor_depth_by_block": depths}))
    return 0


# --------------------------------------------------------------- --check

def _check_bitwise(failures, device):
    """Tiny geometry: the three disciplines' outputs bitwise equal to
    each other and to the exact numpy golden; the async run's device
    blocks on the executor, the host unpack not."""
    host, a = make_capture(32, 2, 3, 2, seed=42)
    outs = {}
    for mode in ("serialized", "sync", "async"):
        got = []
        _, _, depths = run_chain(host, mode, 4, 8, 16, device, collect=got)
        outs[mode] = np.concatenate(got, axis=0)
        want = {"h2d": 4, "xengine": 4, "d2h": 4} if mode == "async" \
            else {}
        ran = {k: v for k, v in depths.items() if v}
        if ran != want:
            failures.append(f"{mode}: executor depths {depths}")
    ntime, nchan, nstand, npol = a.shape
    xm = a.reshape(ntime, nchan, nstand * npol)
    golden = np.stack([
        np.einsum("tci,tcj->cij", np.conj(xm[i * 16:(i + 1) * 16]),
                  xm[i * 16:(i + 1) * 16])
        for i in range(2)]).reshape(2, nchan, nstand, npol, nstand, npol)
    for mode, out in outs.items():
        if out.shape != golden.shape or not np.array_equal(out, golden):
            failures.append(f"{mode} output differs from the numpy golden")
        if out.view(np.uint8).tobytes() != \
                outs["sync"].view(np.uint8).tobytes():
            failures.append(f"{mode} output not bitwise the sync run's")


def _check_overlap(failures, device):
    """With gulp 0 held on the worker, the block thread reserves gulp 1
    and more: the order the synchronous loop cannot produce."""
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
    from bifrost_tpu_torch.pipeline import Pipeline, TransformBlock

    events = []
    gate = threading.Event()

    class Held(TransformBlock):
        def on_sequence(self, iseq):
            return dict(iseq.header)

        def _perf_add(self, **phases):
            if "acquire" in phases:
                events.append("reserved")
            super()._perf_add(**phases)

        def on_data(self, ispan, ospan):
            if not events.count("process"):
                events.append("process")
                gate.wait(20)
            ospan.data.copy_(ispan.data)
            return ispan.nframe

    data = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    config.set("pipeline_async_depth", 4)
    try:
        chunks = []
        with Pipeline(device=device) as pipe:
            src = array_source(data, 8, space="cuda")
            t = Held(src)
            gather_sink(t, chunks)
            runner = threading.Thread(target=pipe.run, daemon=True)
            runner.start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and \
                    events.count("reserved") < 2:
                time.sleep(0.005)
            ahead = events.count("reserved")
            gate.set()
            runner.join(30)
        if ahead < 2:
            failures.append(f"no overlap: {ahead} gulp(s) reserved while "
                            f"gulp 0 was held (expected >= 2)")
        if not np.array_equal(np.concatenate(chunks, axis=0), data):
            failures.append("overlap check: output corrupted")
    finally:
        config.reset("pipeline_async_depth")


def run_check(device):
    failures = []
    _check_bitwise(failures, device)
    _check_overlap(failures, device)
    for f in failures:
        print(f"pipeline_async --check: {f}", file=sys.stderr)
    print(json.dumps({"pipeline_async_check": "ok" if not failures
                      else "FAIL", "failures": len(failures)}))
    return 1 if failures else 0


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ntime", type=int, default=4096,
                   help="frames in the capture stream")
    p.add_argument("--nchan", type=int, default=64)
    p.add_argument("--nstand", type=int, default=8)
    p.add_argument("--npol", type=int, default=2)
    p.add_argument("--gulp", type=int, default=64)
    p.add_argument("--n-int", type=int, default=256,
                   help="X-engine frames per integration")
    p.add_argument("--depth", type=int, default=4,
                   help="pipeline_async_depth of the async discipline")
    p.add_argument("--reps", type=int, default=3,
                   help="interleaved rounds of the three disciplines")
    p.add_argument("--dispatch-latency", type=float, default=0.0,
                   help="GIL-released ms added to each gulp of the device "
                        "blocks")
    p.add_argument("--ring-latency", type=float, default=0.0,
                   help="GIL-released ms added to each nonzero-frame "
                        "acquire/reserve of a 'cuda' ring")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--check", action="store_true",
                   help="fast self-check: the disciplines bitwise, the "
                        "golden, the overlap; no timing")
    args = p.parse_args()
    if args.check:
        return run_check(args.device)
    return measure(args)


if __name__ == "__main__":
    sys.exit(main())
