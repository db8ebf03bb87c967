"""The port's telemetry, `core` and package surface against the JAX
package's: the telemetry CLI (``python -m bifrost_tpu_torch.telemetry``)
in a subprocess with its own HOME, `track_function`'s counters and
timings in the JAX report schema, `core.status_string` for every status
code of csrc/host_status.h (and every other code) as JAX's reads it, and
tests/test_library.py's core-module and lazy-attribute cases."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bifrost_tpu import core as jcore
from bifrost_tpu import telemetry as jtelemetry
from bifrost_tpu_torch import core, telemetry

ROOT = Path(__file__).resolve().parent.parent


def _cli(home, *args):
    env = dict(os.environ, HOME=str(home), PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "bifrost_tpu_torch.telemetry",
                          *args], capture_output=True, text=True,
                         timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip()


def test_telemetry_cli_persists_its_state(tmp_path):
    state = tmp_path / ".bifrost_tpu_torch" / "telemetry_disabled"
    assert _cli(tmp_path) == "telemetry is active"
    assert _cli(tmp_path, "--disable") == "telemetry disabled"
    assert state.exists()
    assert _cli(tmp_path, "--status") == "telemetry is disabled"
    assert _cli(tmp_path, "--enable") == "telemetry enabled"
    assert not state.exists()
    assert _cli(tmp_path, "--status") == "telemetry is active"
    # The JAX package keeps its state elsewhere: untouched.
    assert not (tmp_path / ".bifrost_tpu").exists()


@telemetry.track_function
def _tracked(n):
    return n * 2


def test_track_function_records_calls_and_timings(monkeypatch):
    monkeypatch.setattr(telemetry, "_enabled", True)
    key = f"call:{__name__}._tracked"
    before = telemetry.report()
    assert set(before) == set(jtelemetry.report()) == {"counters",
                                                       "timings"}
    assert [_tracked(i) for i in range(3)] == [0, 2, 4]
    after = telemetry.report()
    assert after["counters"][key] - before["counters"].get(key, 0) == 3
    assert after["timings"][key] > before["timings"].get(key, 0.0)
    telemetry.track_module()
    assert telemetry.report()["counters"][f"import:{__name__}"] >= 1
    monkeypatch.setattr(telemetry, "_enabled", False)
    _tracked(1)
    telemetry.track("off")
    off = telemetry.report()
    assert off["counters"][key] == after["counters"][key]
    assert "off" not in off["counters"]


def test_send_needs_an_endpoint(monkeypatch):
    """No endpoint (the default): nothing is sent, nothing raises."""
    from bifrost_tpu_torch import config
    import urllib.request

    def boom(*a, **k):
        raise AssertionError("telemetry sent without an endpoint")
    monkeypatch.setattr(urllib.request, "urlopen", boom)
    monkeypatch.setattr(telemetry, "_enabled", True)
    telemetry.track("x")
    assert config.get("telemetry_endpoint") == ""
    telemetry._send()


def _host_status_codes():
    text = (ROOT / "bifrost_tpu_torch" / "csrc" / "host_status.h") \
        .read_text()
    return {name: int(v) for name, v in
            re.findall(r"(BT_STATUS_\w+)\s*=\s*(\d+)", text)}


def test_status_strings_match_jax():
    codes = _host_status_codes()
    assert codes["BT_STATUS_SUCCESS"] == 0 and len(codes) >= 10
    for name, code in codes.items():
        assert core.status_string(code) == jcore.status_string(code), name
    for code in range(128):
        assert core.status_string(code) == jcore.status_string(code), code


def test_core_module():
    """tests/test_library.py:27 on the port."""
    assert core.status_string(0) == "success"
    prev = core.debug_enabled()
    assert isinstance(prev, bool)
    try:
        core.set_debug_enabled(True)
        assert core.debug_enabled() is True
    finally:
        core.set_debug_enabled(prev)
    import torch
    assert core.cuda_enabled() is torch.cuda.is_available()


@pytest.mark.parametrize("name", ["affinity", "core", "config", "shmring",
                                  "block_chainer", "units", "temp_storage",
                                  "trace", "tools", "telemetry", "proclog"])
def test_lazy_package_attributes(name):
    """tests/test_library.py:42 on the port: every exported submodule
    resolves."""
    import importlib
    import bifrost_tpu_torch as bt
    assert getattr(bt, name) is importlib.import_module(
        f"bifrost_tpu_torch.{name}")
    with pytest.raises(AttributeError):
        getattr(bt, "no_such_module")
