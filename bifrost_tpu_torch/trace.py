"""Trace ranges and programmatic profiling (counterpart of
bifrost_tpu/trace.py; the reference's NVTX ranges, src/trace.hpp).

- `trace_scope(name)` / `@traced`: a named range where the `trace` flag
  is on (read per call, so `config.set("trace", True)` after import
  takes effect): a `torch.profiler.record_function` range, which a
  `start_profile` capture records, and on the card also an NVTX range
  (`torch.cuda.nvtx`), which Nsight shows.  With the flag off a scope
  costs one flag read and imports no profiler.
- `start_profile(log_dir)` / `stop_profile()`: a `torch.profiler`
  capture of CPU activity and, on the card, CUDA activity, over every
  thread where this PyTorch offers that (the pipeline's blocks run on
  their own threads); `stop_profile` writes a Chrome trace into
  `log_dir` and returns its path.  On a CUDA device a capture that
  cannot record CUDA activity raises: it never carries on CPU-only.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile

from . import config

__all__ = ["trace_scope", "traced", "start_profile", "stop_profile",
           "TRACE_FILE", "TRACE_ENABLED"]

TRACE_FILE = "trace.json"     # the Chrome trace stop_profile writes

_profile = None               # (profiler, log_dir, on the card)


def _enabled():
    return bool(config.get("trace"))


# The flag's value at import (bifrost_tpu/trace.py:28); live checks read
# the flag, so config.set("trace", ...) after import takes effect.
TRACE_ENABLED = _enabled()


@contextlib.contextmanager
def trace_scope(name):
    """A named trace range around the body (module docstring)."""
    if not _enabled():
        yield
        return
    import torch
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def traced(fn):
    """Decorator: run `fn` in a trace range named after it; the flag is
    read per call."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with trace_scope(f"{fn.__module__}.{fn.__qualname__}"):
            return fn(*args, **kwargs)
    return wrapper


def _profiler(cuda):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        if torch.profiler.ProfilerActivity.CUDA not in \
                torch.profiler.supported_activities():
            raise RuntimeError("start_profile: this PyTorch cannot record "
                               "CUDA activity on the card")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=acts)
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def start_profile(log_dir=None, device=None):
    """Start a capture (module docstring); `device`: 'cpu' records the
    host alone, None or a CUDA device records the card too where there
    is one.  -> log_dir."""
    global _profile
    import torch
    if _profile is not None:
        raise RuntimeError("start_profile: a capture is already running")
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "bifrost_tpu_torch_profile")
    cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    prof = _profiler(cuda)
    prof.__enter__()
    if cuda:
        # A marker on the card: the capture must show device activity.
        torch.ones(1, device=device or "cuda").add_(1)
    _profile = (prof, log_dir, cuda)
    return log_dir


def stop_profile():
    """End the capture and write its Chrome trace into the log
    directory; -> the trace's path (None without a capture)."""
    global _profile
    if _profile is None:
        return None
    prof, log_dir, cuda = _profile
    _profile = None
    if cuda:
        import torch
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if cuda and not _device_events(path):
        raise RuntimeError("stop_profile: the capture holds no CUDA "
                           "activity on the card")
    return path


def _device_events(path):
    import json
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
