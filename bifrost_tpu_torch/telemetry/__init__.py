"""Local usage counters (counterpart of bifrost_tpu/telemetry/__init__.py).

The JAX package batches named counters for an optional HTTP endpoint;
the port keeps the counters only, in this process, and transmits
nothing.  `supervise.Supervisor` tracks every supervise event kind here
(``supervise:<kind>``) and `service.Service` its degrade episodes.
"""

from __future__ import annotations

import threading

__all__ = ["track", "report"]

_lock = threading.Lock()
_counters = {}


def track(name, count=1):
    with _lock:
        _counters[name] = _counters.get(name, 0) + count


def report():
    """{name: count} of everything tracked so far."""
    with _lock:
        return dict(_counters)

