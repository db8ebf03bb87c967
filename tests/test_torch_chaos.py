"""The port's chaos harness (benchmarks_torch/frb_service.py) on the CPU:
its `--check` matrix (clean, drop storm, malformed stream, reorder + dup
+ flap with a capture-tier fault, wedge + deadman, the restart storm run
twice for its replay signature, the budget edge, the RFI storm flagged,
unflagged and again) run once, as a user runs it, with `--device cpu`;
and its traffic generator against the JAX harness's: for every scenario
the same seed gives the same schedule hash and the same wire bytes."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = _load("benchmarks_torch/frb_service.py", "torch_frb_service")


def test_check_matrix_passes_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks_torch",
                                      "frb_service.py"),
         "--check", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    assert lines, res.stdout + res.stderr
    out = json.loads(lines[-1])
    assert out["frb_service_check"] == "ok", (out, res.stderr[-4000:])
    assert res.returncode == 0
    assert out["scenarios"] == len(PORT.SCENARIOS) + 3
    assert out["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(PORT.SCENARIOS))
def test_schedule_equals_the_jax_harness(name):
    jax_h = _load("benchmarks/frb_service.py", "jax_frb_service")
    kw = PORT.SCENARIOS[name]["traffic_kwargs"]
    for first, n in ((0, 256), (256, 1024)):      # warm-up, chaos phase
        a = PORT.build_schedule(7, first, n, **kw)
        b = jax_h.build_schedule(7, first, n, **kw)
        assert PORT.schedule_hash(a) == jax_h.schedule_hash(b)
        ca = PORT.compile_schedule(a, PORT.DEFAULT_RATE_PPS)
        cb = jax_h.compile_schedule(b, jax_h.DEFAULT_RATE_PPS)
        assert ca == cb
