"""The port's observability plane against the JAX package's: every ring
writes `rings/<name>` with the C engine's keys (cpp/src/ring.cpp:183-207)
and the same values after the same commits; `proclog.ring_metrics`,
`stall_pct` and `fusion_metrics` give the JAX rows on the same parsed
tree; and tests/test_tools.py's six cases against a live port pipeline
in a subprocess (on the CPU), each tool run as ``python -m
bifrost_tpu_torch.tools.<name>``."""

import os
import select
import subprocess
import sys
import tempfile
import time
import uuid

import numpy as np
import pytest
import torch

from bifrost_tpu import proclog as jproclog
from bifrost_tpu.ring import Ring as JaxRing
from bifrost_tpu_torch import proclog
from bifrost_tpu_torch.memory import SPACEMAP, SPACEMAP_INV
from bifrost_tpu_torch.ring import GEOMETRY_LOG_S
from bifrost_tpu_torch.ring import Ring as PortRing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"capacity", "ghost", "nringlet", "tail", "head", "reserve_head",
        "guarantee", "space"}


def _hdr(nchan, dtype):
    return {"name": "g", "time_tag": 0, "_tensor": {
        "dtype": dtype, "shape": [-1, nchan], "labels": ["time", "x"]}}


def _jax_ring_log(name):
    return jproclog.load_by_pid(os.getpid()).get("rings", {}).get(name)


def _port_ring_log(name):
    return proclog.load_by_pid(os.getpid()).get("rings", {}).get(name)


def _stream(ring, write, resize=None):
    """Two guaranteed readers, one a gulp behind the other; 10 gulps of
    4 frames of (4,) f32 in a 12-frame ring; the last commit after the
    commit-time throttle, so both engines log it."""
    with ring.begin_writing() as w:
        with w.begin_sequence(_hdr(4, "f32"), gulp_nframe=4,
                              buf_nframe=12) as seq:
            slow = ring.open_earliest_sequence(guarantee=True)
            fast = ring.open_earliest_sequence(guarantee=True)
            for g in range(10):
                if g == 9:
                    time.sleep(2 * GEOMETRY_LOG_S)
                with seq.reserve(4) as span:
                    write(span, np.full((4, 4), g, np.float32))
                if g >= 1:
                    with slow.acquire(4 * (g - 1), 4):
                        pass
                with fast.acquire(4 * g, 4):
                    pass
            if resize is not None:
                resize(ring)
    slow.close()
    fast.close()


def _write_jax(span, a):
    span.data[...] = a


def _write_port(span, a):
    span.data.copy_(torch.from_numpy(a))


def test_ring_logs_match_the_c_engine():
    """After the same commits the two rings' logs hold the same keys, and
    every value is equal: both engines lay the ring out alike where the
    sizes are multiples of the element size, as every stream's are."""
    name = f"logcmp_{uuid.uuid4().hex[:8]}"
    jring = JaxRing(space="system", name=name)
    pring = PortRing(space="system", name=name, device="cpu")
    _stream(jring, _write_jax)
    _stream(pring, _write_port)
    jlog, plog = _jax_ring_log(name), _port_ring_log(name)
    assert jlog is not None and plog is not None
    assert set(plog) == set(jlog) == KEYS
    assert plog == jlog
    # Logged at the last commit: the slow reader (then at the 8th gulp)
    # is the guarantee; head and reserve_head sit at the 10th gulp's end,
    # the tail a capacity back.
    assert plog["head"] == plog["reserve_head"] == 10 * 4 * 16
    assert plog["guarantee"] == 7 * 4 * 16
    assert plog["tail"] == plog["head"] - plog["capacity"]
    assert plog["space"] == SPACEMAP["system"] == 1


def test_ring_log_capacity_differs_by_design_on_a_bare_resize():
    """A resize called without a stream rounds the port's capacity and
    ghost up to 16 bytes (the default element alignment, ring.py), where
    the C engine takes the sizes as given; the tail, which moves by
    capacity, then differs the same way.  head, reserve_head and
    guarantee, which count bytes committed, are equal."""
    name = f"logrsz_{uuid.uuid4().hex[:8]}"
    jring = JaxRing(space="system", name=name)
    pring = PortRing(space="system", name=name, device="cpu")
    jring.resize(10, 40)
    pring.resize(10, 40)
    jlog, plog = _jax_ring_log(name), _port_ring_log(name)
    assert (jlog["capacity"], jlog["ghost"]) == (40, 10)
    assert (plog["capacity"], plog["ghost"]) == (48, 16)
    for key in ("head", "reserve_head", "guarantee", "tail", "nringlet",
                "space"):
        assert plog[key] == jlog[key], key


def test_every_port_ring_logs_its_space():
    name = f"logcuda_{uuid.uuid4().hex[:8]}"
    for space in ("system", "cuda_host", "cuda"):
        ring = PortRing(space=space, name=f"{name}_{space}", device="cpu")
        ring.resize(64)
        log = _port_ring_log(f"{name}_{space}")
        assert set(log) == KEYS
        assert SPACEMAP_INV[log["space"]] == space


def test_ring_log_names_unique_among_live_rings():
    """Two live rings of one name (two pipelines of one topology in one
    process) log to two files, `<name>` and `<name>#2`; destroying the
    first unlinks its own log only, and its name is free again."""
    import gc
    name = f"logdup_{uuid.uuid4().hex[:8]}"
    first = PortRing(space="system", name=name, device="cpu")
    second = PortRing(space="system", name=name, device="cpu")
    assert (first.log_name, second.log_name) == (name, f"{name}#2")
    first.resize(64)
    second.resize(128)
    assert _port_ring_log(name)["capacity"] == 256
    assert _port_ring_log(f"{name}#2")["capacity"] == 512
    del first
    gc.collect()
    assert _port_ring_log(name) is None
    assert _port_ring_log(f"{name}#2")["capacity"] == 512
    third = PortRing(space="system", name=name, device="cpu")
    assert third.log_name == name
    assert _port_ring_log(f"{name}#2")["capacity"] == 512
    del second, third


def test_ring_log_release_inside_a_claim_does_not_deadlock():
    """The collector may run a Ring's __del__ on any allocation, also
    while its thread holds the log-name registry's lock: the release
    must not wait on that lock."""
    import gc
    import threading

    from bifrost_tpu_torch import ring as ring_mod
    name = f"logdel_{uuid.uuid4().hex[:8]}"

    def drop_inside_claim():
        ring = PortRing(space="system", name=name, device="cpu")
        ring.cycle = ring        # collected by gc, not by refcount
        del ring
        with ring_mod._LOG_NAMES_LOCK:
            gc.collect()

    th = threading.Thread(target=drop_inside_claim, daemon=True)
    th.start()
    th.join(10.0)
    assert not th.is_alive(), "Ring.__del__ waited on the registry lock"
    assert name not in ring_mod._LOG_NAMES


def _small_fused_pipeline():
    """A fused port pipeline on the CPU (copy -> transpose -> detect in
    one group), run to its end -> its parsed tree."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
    from bifrost_tpu_torch.pipeline import Pipeline
    data = np.zeros((16, 4, 8, 2, 2), np.int8)
    out = []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 2, header={
            "dtype": "ci8", "labels": ["time", "freq", "fine_time", "pol"]})
        with bt.block_scope(fuse=True):
            dev = blocks.copy(src, space="cuda")
            t = blocks.transpose(dev, ["time", "pol", "freq", "fine_time"])
            d = blocks.detect(t, mode="stokes")
        gather_sink(d, out)
        pipe.run()
    return proclog.load_by_pid(os.getpid())


def test_metrics_match_jax_on_the_same_tree():
    tree = _small_fused_pipeline()
    rings = proclog.ring_metrics(tree)
    assert rings and rings == jproclog.ring_metrics(tree)
    fusion = proclog.fusion_metrics(tree)
    assert any(r["groups"] >= 1 for r in fusion)
    assert fusion == jproclog.fusion_metrics(tree)
    perfs = [logs["perf"] for logs in tree.values() if "perf" in logs]
    assert perfs
    for perf in perfs + [{}, {"total_acquire_time": 1.0,
                              "total_process_time": 3.0}]:
        assert proclog.stall_pct(perf) == jproclog.stall_pct(perf)
    assert proclog.cmdline(os.getpid()) == jproclog.cmdline(os.getpid())
    # A tool never lists itself; this process has a tree, so it is not
    # in its own list either.
    assert os.getpid() not in proclog.list_pids()


# ------------------------------------------------------------------ tools
PIPELINE = r"""
import sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
from bifrost_tpu_torch import blocks
from bifrost_tpu_torch.pipeline import Pipeline
from bifrost_tpu_torch.blocks.testing import array_source, callback_sink

data = (np.random.rand(%(nframe)d, 4096) + 1j * np.random.rand(
    %(nframe)d, 4096)).astype(np.complex64)
with Pipeline(device="cpu") as pipe:
    src = array_source(data, 4)
    scaled = blocks.detect(src, mode="power")
    callback_sink(scaled, on_data=lambda a: time.sleep(0.15))
    print("RUNNING", flush=True)
    pipe.run()
print("DONE", flush=True)
"""

FUSED_PIPELINE = r"""
import sys, time
sys.path.insert(0, %(repo)r)
import numpy as np
import bifrost_tpu_torch as bt
from bifrost_tpu_torch import blocks
from bifrost_tpu_torch.pipeline import Pipeline
from bifrost_tpu_torch.blocks.testing import array_source, callback_sink

data = np.zeros((96, 4, 32, 2), dtype=[("re", "i1"), ("im", "i1")])
with Pipeline(device="cpu") as pipe:
    src = array_source(data, 2, header={
        "dtype": "ci8", "labels": ["time", "freq", "fine_time", "pol"]})
    with bt.block_scope(fuse=True):
        dev = blocks.copy(src, space="cuda")
        t = blocks.transpose(dev, ["time", "pol", "freq", "fine_time"])
        d = blocks.detect(t, mode="stokes")
    callback_sink(d, on_data=lambda a: time.sleep(0.15))
    print("RUNNING", flush=True)
    pipe.run()
print("DONE", flush=True)
"""


TWO_FRB_SEARCHES = r"""
import sys, threading, time
sys.path.insert(0, %(repo)r)
import numpy as np
from bifrost_tpu_torch.service import frb_search_pipeline

data = np.random.default_rng(7).integers(0, 32, (64 * 120, 32)).astype(
    np.uint8)
pipes = []
for _ in range(2):
    pipe, det, _ = frb_search_pipeline(data, 64, 16, device="cpu")
    on_data = det.on_data

    def held(ispan, on_data=on_data):
        time.sleep(0.15)
        return on_data(ispan)
    det.on_data = held
    pipes.append(pipe)
threads = [threading.Thread(target=p.run) for p in pipes]
for t in threads:
    t.start()
print("RUNNING", flush=True)
for t in threads:
    t.join()
print("DONE", flush=True)
"""


def _spawn(script, env, **fmt):
    errf = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", script % dict(repo=REPO, **fmt)],
        stdout=subprocess.PIPE, stderr=errf, text=True, cwd=REPO, env=env)
    deadline, buf = time.monotonic() + 60, ""
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if ready:
            buf += proc.stdout.readline()
            if "RUNNING" in buf:
                time.sleep(2.0)    # a few gulps, a throttled perf flush
                return proc
        if proc.poll() is not None:
            break
    proc.kill()
    errf.seek(0)
    raise AssertionError(f"pipeline subprocess failed to start: "
                         f"{errf.read()[-2000:]}")


@pytest.fixture(scope="module")
def tree_env(tmp_path_factory):
    """The port's tree in a directory of this module's own, for the
    pipelines and the tools alike."""
    return dict(os.environ, BT_TORCH_PROCLOG_DIR=str(
        tmp_path_factory.mktemp("proclog")))


@pytest.fixture(scope="module")
def live(tree_env):
    """One slow pipeline the five tools' cases share: 200 gulps, its sink
    sleeping 0.15 s a gulp (about 30 s), killed at the module's end."""
    proc = _spawn(PIPELINE, tree_env, nframe=800)
    yield proc
    proc.kill()
    proc.wait()


def _run_tool(env, tool, *args, ok=True):
    out = subprocess.run(
        [sys.executable, "-m", f"bifrost_tpu_torch.tools.{tool}", *args],
        capture_output=True, text=True, timeout=60, cwd=REPO, env=env)
    if ok:
        assert out.returncode == 0, out.stderr[-2000:]
    return out


def test_like_top_shows_live_stall_and_rings(live, tree_env):
    out = _run_tool(tree_env, "like_top", str(live.pid)).stdout
    block_rows = [ln for ln in out.splitlines() if ln.startswith("block ")]
    ring_rows = [ln for ln in out.splitlines() if ln.startswith("ring ")]
    assert block_rows, f"no block rows in like_top snapshot:\n{out}"
    assert any("stall_pct=" in ln for ln in block_rows)
    stalls = [float(ln.split("stall_pct=")[1].split()[0])
              for ln in block_rows]
    assert max(stalls) > 0.0, f"all stalls zero:\n{out}"
    assert any("backlog_pct=" in ln for ln in ring_rows)
    names = {ln.split("name=")[1] for ln in ring_rows}
    assert names == {"ArraySourceBlock_0.out0", "DetectBlock_1.out0"}, out


def test_like_top_shows_fusion_groups(tree_env):
    proc = _spawn(FUSED_PIPELINE, tree_env)
    try:
        out = _run_tool(tree_env, "like_top", str(proc.pid)).stdout
    finally:
        proc.kill()
        proc.wait()
    fusion_rows = [ln for ln in out.splitlines() if ln.startswith("fusion ")]
    group_rows = [ln for ln in out.splitlines()
                  if ln.startswith("fusion_group ")]
    assert any("pipeline_fuse=1" in ln and "ring_hops_eliminated=" in ln
               for ln in fusion_rows), out
    assert any("CopyBlock" in ln and "DetectBlock" in ln
               for ln in group_rows), out
    ring_rows = [ln for ln in out.splitlines() if ln.startswith("ring ")]
    assert ring_rows, out


def test_like_bmon_shows_ring_rates(live, tree_env):
    out = _run_tool(tree_env, "like_bmon", "-i", "1.0").stdout
    ring_rows = [ln for ln in out.splitlines() if ln.startswith("ring ")]
    assert any(f"({live.pid}," in ln for ln in ring_rows), \
        f"pipeline pid {live.pid} not in like_bmon snapshot:\n{out}"
    rates = [float(ln.rsplit(None, 1)[1]) for ln in out.splitlines()
             if ln.startswith("rate ")]
    assert rates and max(rates) > 0.0, out


def test_like_ps_shows_process_and_block_rows(live, tree_env):
    out = _run_tool(tree_env, "like_ps", str(live.pid)).stdout
    assert str(live.pid) in out
    assert "USER" in out and "THR" in out
    assert "source" in out and "sink" in out, out
    assert "STALL%" in out


def test_like_pmap_shows_ring_geometry_and_totals(live, tree_env):
    out = _run_tool(tree_env, "like_pmap", str(live.pid)).stdout
    assert "CAPACITY" in out and "TOTAL system" in out, out
    assert "ArraySourceBlock" in out, out
    assert "KiB" in out or "MiB" in out, out


def test_pipeline2dot_draws_block_edges(live, tree_env):
    out = _run_tool(tree_env, "pipeline2dot", str(live.pid)).stdout
    assert "digraph" in out
    assert "ArraySourceBlock" in out and "DetectBlock" in out, out
    edges = [ln for ln in out.splitlines()
             if "->" in ln and "Detect" in ln and "Source" in ln]
    assert edges, f"no source->detect edge:\n{out}"
    assert "cf32" in out or "f32" in out, out
    out2 = _run_tool(tree_env, "pipeline2dot", "--rings",
                     str(live.pid)).stdout
    assert "cylinder" in out2 and "system" in out2, out2


def test_tools_start_without_torch(tmp_path):
    """A tool loads neither torch nor numpy: `import bifrost_tpu_torch` is
    lazy, so it starts at once beside a running pipeline."""
    code = ("import runpy, sys\n"
            "sys.argv = ['like_pmap', '1']\n"
            "try:\n"
            "    runpy.run_module('bifrost_tpu_torch.tools.like_pmap', "
            "run_name='__main__')\n"
            "except SystemExit:\n"
            "    pass\n"
            "print('torch' in sys.modules, 'numpy' in sys.modules)\n")
    env = dict(os.environ, BT_TORCH_PROCLOG_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60, cwd=REPO, env=env)
    assert out.stdout.strip().splitlines()[-1] == "False False", out


def test_two_frb_searches_in_one_process_keep_block_rows_apart(tree_env):
    """Block logs follow the ring logs' rule: the second FRB search's
    blocks log as `<name>#2`, so like_top has a row for each block of
    both chains, each with its own counters (the JAX package keys block
    logs by name alone, so its rows would clobber)."""
    proc = _spawn(TWO_FRB_SEARCHES, tree_env)
    try:
        top = _run_tool(tree_env, "like_top", str(proc.pid)).stdout
    finally:
        proc.kill()
        proc.wait()
    rows = {ln.split("name=")[1]: ln for ln in top.splitlines()
            if ln.startswith("block ")}
    sources = [n for n in rows if n.startswith("ArraySourceBlock_")]
    base = ["detect", "fdmt", "h2d", "transpose"]
    assert len(set(sources)) == 2, top
    assert sorted(rows) == sorted(sources + base +
                                  [f"{n}#2" for n in base]), top
    for n in ("h2d", "h2d#2", "fdmt", "fdmt#2"):
        assert float(rows[n].split("total=")[1].split()[0]) > 0.0, top


def test_tools_without_a_port_tree_say_so(tmp_path):
    env = dict(os.environ, BT_TORCH_PROCLOG_DIR=str(tmp_path))
    for tool in ("like_top", "like_ps", "like_pmap", "like_bmon",
                 "pipeline2dot"):
        out = _run_tool(env, tool, ok=False)
        assert out.returncode == 1, (tool, out.stdout, out.stderr)
        assert "no live bifrost_tpu_torch pipelines" in out.stderr, tool


def test_two_frb_searches_in_one_process_give_two_ring_rows(tree_env):
    """Two FRB searches of one topology live in one process: like_top has
    a ring row for each of the eight rings (the second pipeline's logged
    as `<name>#2`), and like_bmon's rates are each ring's own: none
    negative, and both pipelines' rings advancing."""
    proc = _spawn(TWO_FRB_SEARCHES, tree_env)
    try:
        top = _run_tool(tree_env, "like_top", str(proc.pid)).stdout
        bmon = _run_tool(tree_env, "like_bmon", "-i", "1.0",
                         str(proc.pid)).stdout
    finally:
        proc.kill()
        proc.wait()
    names = sorted(ln.split("name=")[1] for ln in top.splitlines()
                   if ln.startswith("ring "))
    # The sources' rings are named by their blocks' numbers; the chains'
    # blocks have fixed names.
    sources = [n for n in names if n.startswith("ArraySourceBlock_")]
    base = ["fdmt.out0", "h2d.out0", "transpose.out0"]
    assert len(set(sources)) == 2, top
    assert names == sorted(sources + base + [f"{n}#2" for n in base]), top
    rates = {ln.split("'")[1]: float(ln.rsplit(None, 1)[1])
             for ln in bmon.splitlines() if ln.startswith("rate ")}
    assert set(rates) == set(names), bmon
    assert min(rates.values()) >= 0.0, bmon
    assert rates["h2d.out0"] > 0.0 and rates["h2d.out0#2"] > 0.0, bmon
