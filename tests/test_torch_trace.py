"""The port's trace ranges (bifrost_tpu_torch.trace, counterpart of
bifrost_tpu/trace.py): with the `trace` flag off a `trace_scope` records
nothing and imports no profiler; with it on, a CPU `start_profile` /
`stop_profile` capture holds the ranges of `trace_scope`, `@traced` and
the pipeline's block threads, in the Chrome trace `stop_profile`
writes."""

import json

import numpy as np
import pytest

from bifrost_tpu_torch import config, trace


@trace.traced
def _work(n):
    return sum(range(n))


def _names(path):
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def _capture(tmp_path, body):
    trace.start_profile(str(tmp_path), device="cpu")
    try:
        body()
    finally:
        path = trace.stop_profile()
    assert path == str(tmp_path / trace.TRACE_FILE)
    return _names(path)


@pytest.fixture
def trace_flag():
    yield
    config.reset("trace")


def test_flag_off_records_nothing(tmp_path, trace_flag):
    config.set("trace", False)

    def body():
        with trace.trace_scope("observe.off"):
            _work(10)
    names = _capture(tmp_path, body)
    assert "observe.off" not in names
    assert not any(n.endswith("._work") for n in names)


def test_flag_off_touches_no_profiler(monkeypatch, trace_flag):
    """With the flag off a scope is one flag read: no profiler range, no
    NVTX call."""
    import torch

    def boom(*a, **k):
        raise AssertionError("profiler touched with the trace flag off")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    config.set("trace", False)
    with trace.trace_scope("observe.off"):
        assert _work(4) == 6
    config.set("trace", True)
    with pytest.raises(AssertionError, match="flag off"):
        with trace.trace_scope("observe.on"):
            pass


def test_flag_on_records_scopes_traced_functions_and_blocks(tmp_path,
                                                            trace_flag):
    from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
    from bifrost_tpu_torch.pipeline import Pipeline
    config.set("trace", True)
    out = []

    def body():
        with trace.trace_scope("observe.on"):
            _work(10)
        with Pipeline(device="cpu") as pipe:
            gather_sink(array_source(np.zeros((8, 4), np.float32), 4),
                        out, name="tsink")
            pipe.run()
    names = _capture(tmp_path, body)
    assert "observe.on" in names
    assert f"{__name__}._work" in names
    assert "block:tsink" in names
    assert any(n.startswith("block:ArraySourceBlock_") for n in names)
    assert len(out) == 2


def test_start_profile_twice_raises(tmp_path):
    trace.start_profile(str(tmp_path), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already running"):
            trace.start_profile(str(tmp_path), device="cpu")
    finally:
        trace.stop_profile()
    assert trace.stop_profile() is None
