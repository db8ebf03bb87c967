"""Usage telemetry (counterpart of bifrost_tpu/telemetry/__init__.py;
reference python/bifrost/telemetry/__init__.py): named counters and
call timings, batched in this process and POSTed at exit to the
`telemetry_endpoint` config flag's URL, where one is set (none by
default: nothing leaves the process).

Telemetry is active unless disabled, and disabling persists: a state
file under the user's home, in the port's own directory
(``~/.bifrost_tpu_torch/telemetry_disabled``), which ``python -m
bifrost_tpu_torch.telemetry --disable`` writes and ``--enable`` removes.
`supervise.Supervisor` tracks every supervise event kind here
(``supervise:<kind>``), `service.Service` its degrade episodes, the UDP
engine its packet counters and the fleet its events.
"""

from __future__ import annotations

import atexit
import functools
import inspect
import os
import threading
import time

__all__ = ["is_active", "enable", "disable", "track", "track_module",
           "track_function", "report"]

_lock = threading.Lock()
_counters = {}
_timings = {}


def _state_file():
    return os.path.join(os.path.expanduser("~"), ".bifrost_tpu_torch",
                        "telemetry_disabled")


_enabled = not os.path.exists(_state_file())


def is_active():
    return _enabled


def enable():
    """Turn telemetry on, here and for later processes."""
    global _enabled
    try:
        os.remove(_state_file())
    except OSError:
        pass
    _enabled = True


def disable():
    """Turn telemetry off, here and for later processes."""
    global _enabled
    try:
        os.makedirs(os.path.dirname(_state_file()), exist_ok=True)
        with open(_state_file(), "w") as f:
            f.write("disabled\n")
    except OSError:
        pass
    _enabled = False


def track(name, count=1):
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + count


def track_module():
    """Count an import of the calling module (``import:<module>``)."""
    frame = inspect.currentframe()
    try:
        mod = frame.f_back.f_globals.get("__name__", "?")
    finally:
        del frame
    track(f"import:{mod}")


def track_function(fn):
    """Decorator: count the calls of `fn` and add up their wall seconds
    (``call:<module>.<qualname>``)."""
    key = f"call:{fn.__module__}.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _enabled:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            with _lock:
                _counters[key] = _counters.get(key, 0) + 1
                _timings[key] = _timings.get(key, 0.0) + dt
    return wrapper


def report():
    """{"counters": {name: count}, "timings": {name: seconds}}."""
    with _lock:
        return {"counters": dict(_counters), "timings": dict(_timings)}


def _send():
    """POST the batch to the `telemetry_endpoint` flag's URL, if one is
    set; never raises."""
    from .. import config
    endpoint = config.get("telemetry_endpoint") or None
    if not endpoint or not _enabled or not _counters:
        return
    try:
        import json
        import urllib.request
        req = urllib.request.Request(
            endpoint, data=json.dumps(report()).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=2)
    except Exception:  # noqa: BLE001 — telemetry never breaks the host
        pass


atexit.register(_send)
