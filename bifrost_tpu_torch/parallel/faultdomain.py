"""Device fault domains: the device registry and availability accounting
(counterpart of bifrost_tpu/parallel/faultdomain.py:61-430).

A device is a string key (a `torch.device`, an int index into the CUDA
devices, or any string: the tests and the fleet's chaos scripts use named
fake devices).  The registry holds:

- the lost set (`mark_lost` / `mark_restored`): health, as a prober
  would report it; loss alone changes nothing;
- the evicted set (`evict` / `restore`): devices taken out of service.
  An eviction that followed a loss becomes restorable once health
  returns (`restorable_devices`); a manual one sticks until `restore`;
- the transition ledger (`transitions`) and its listeners
  (`add_transition_listener`), fired after every lost / restored /
  evict / restore / resize transition on the transitioning thread; this
  is how `fleet.FleetScheduler` learns that its device budget shrank;
- availability: `availability_pct()` is 100 * (1 - evicted
  device-seconds / (tracked devices * window)), `downtime_by_device()`
  itemises it.  As in the JAX package, an eviction tracks its device and
  the window opens at the first mesh registration; the port registers
  no mesh (ROADMAP item 17), so availability reads 100 %, whatever
  `downtime_by_device` itemises.

All registry state is module-global and thread-safe; `reset()` restores
a clean slate for tests and scenario harnesses (listeners stay).

Not ported (ROADMAP item 17, A16): the collective watchdog
(`CollectiveWatchdog`, `guarded_call`, `guarded`), the realign of
arguments onto a rebuilt mesh and `effective_mesh`'s rebuild.  The port
runs no mesh, so `effective_mesh` of None is None and anything else
raises.
"""

from __future__ import annotations

import threading
import time

__all__ = ["ShardFault", "CollectiveWatchdog", "guarded_call", "guarded",
           "mark_lost", "mark_restored", "lost_devices", "is_lost",
           "evict", "restore", "evicted_devices", "restorable_devices",
           "is_evicted", "effective_mesh", "note_geometry_change",
           "shard_health", "tracked_devices", "availability_pct",
           "downtime_by_device", "transitions", "reset",
           "add_transition_listener", "remove_transition_listener"]

_NOT_PORTED = "is not ported yet (ROADMAP item 17, A16: the mesh)"


class ShardFault(RuntimeError):
    """A sharded dispatch missed its collective deadline (the JAX
    package's exception; the port raises it nowhere yet).  `device` is
    the suspected device key, `block` the dispatching block's name,
    `gulp` the input frame of the gulp in flight."""

    def __init__(self, device=None, block=None, gulp=None, reason=None):
        self.device = device
        self.block = block
        self.gulp = gulp
        self.reason = reason or "collective deadline exceeded"
        super().__init__(
            f"shard fault: {self.reason} "
            f"(device={device!r}, block={block!r}, gulp={gulp!r})")


# ------------------------------------------------------- device registry
_lock = threading.RLock()
_lost = {}          # device key -> monotonic stamp marked lost
_evicted = {}       # device key -> monotonic stamp evicted
_transitions = []   # (kind, device key, monotonic stamp)
_tracked = set()    # device keys ever evicted
_window_t0 = None   # availability window start (first mesh registration)
MAX_TRANSITIONS = 4096


def _dev_key(device):
    """Stable string key for a device: a string, an int CUDA index, or a
    torch.device (its str)."""
    if isinstance(device, str):
        return device
    if isinstance(device, int):
        return f"cuda:{device}"
    return str(device)


def _note_transition(kind, key):
    # caller holds _lock
    _transitions.append((kind, key, time.monotonic()))
    del _transitions[:-MAX_TRANSITIONS]


def mark_lost(device, reason=None):
    """Declare `device` unhealthy.  Loss alone changes no service:
    eviction does."""
    key = _dev_key(device)
    with _lock:
        noted = key not in _lost
        if noted:
            _lost[key] = time.monotonic()
            _note_transition("lost", key)
    if noted:
        _fire_listeners("lost", key)
    return key


def mark_restored(device):
    """Declare `device` healthy again: an eviction that followed its loss
    becomes restorable."""
    key = _dev_key(device)
    with _lock:
        noted = _lost.pop(key, None) is not None
        if noted:
            _note_transition("restored", key)
    if noted:
        _fire_listeners("restored", key)
    return key


def lost_devices():
    with _lock:
        return sorted(_lost)


def is_lost(device):
    with _lock:
        return _dev_key(device) in _lost


# Transition listeners: cb(kind, device_key) after a transition is
# recorded, on the transitioning thread, so a listener only flags work
# (fleet.FleetScheduler parks it for its next poll).  reset() keeps them:
# they belong to their registrant's lifecycle.
_listeners = []


def add_transition_listener(cb):
    with _lock:
        if cb not in _listeners:
            _listeners.append(cb)
    return cb


def remove_transition_listener(cb):
    with _lock:
        try:
            _listeners.remove(cb)
        except ValueError:
            pass


def _fire_listeners(kind, key):
    # Outside _lock: a listener may read the registry.
    with _lock:
        listeners = list(_listeners)
    for cb in listeners:
        try:
            cb(kind, key)
        except Exception:  # noqa: BLE001 — observers never break eviction
            pass


# Evictions that followed a loss (mark_lost): only these become
# restorable when health returns.
_evict_lost = set()


def evict(device):
    """Take `device` out of service.  -> True where this call made the
    transition, False where it was evicted already (callers that book
    events key on the transition, so two cannot double-book one)."""
    key = _dev_key(device)
    with _lock:
        if key in _evicted:
            return False
        _evicted[key] = time.monotonic()
        _tracked.add(key)
        if key in _lost:
            _evict_lost.add(key)
        _note_transition("evict", key)
    _fire_listeners("evict", key)
    return True


def restore(device):
    """Return an evicted `device` to service -> True where this call made
    the transition."""
    key = _dev_key(device)
    with _lock:
        if _evicted.pop(key, None) is None:
            return False
        _evict_lost.discard(key)
        _note_transition("restore", key)
    _fire_listeners("restore", key)
    return True


def note_geometry_change(tag="resize"):
    """Record a change of device shares that is not an eviction or a
    restore (a fleet tenant resize) and fire the listeners.  The JAX
    package also rebuilds every mesh here; the port runs none (ROADMAP
    item 17)."""
    with _lock:
        _note_transition("resize", tag)
    _fire_listeners("resize", tag)


def evicted_devices():
    with _lock:
        return sorted(_evicted)


def is_evicted(device):
    with _lock:
        return _dev_key(device) in _evicted


def restorable_devices():
    """Evicted devices whose health has returned (evicted while lost, no
    longer lost): what an auto-restore pass should `restore`."""
    with _lock:
        return sorted(k for k in _evicted
                      if k in _evict_lost and k not in _lost)


def reset():
    """Clean slate: forget losses, evictions, transitions and tracked
    devices."""
    global _window_t0
    with _lock:
        _lost.clear()
        _evicted.clear()
        del _transitions[:]
        _tracked.clear()
        _evict_lost.clear()
        _window_t0 = None


def transitions():
    """Copy of the (kind, device, monotonic stamp) transition ledger."""
    with _lock:
        return list(_transitions)


def tracked_devices():
    with _lock:
        return sorted(_tracked)


def shard_health(now=None):
    """{device: {healthy, evicted, evicted_for_s}} of every tracked
    device."""
    now = time.monotonic() if now is None else now
    with _lock:
        return {
            key: {
                "healthy": key not in _lost,
                "evicted": key in _evicted,
                "evicted_for_s": round(now - _evicted[key], 3)
                if key in _evicted else None,
            }
            for key in sorted(_tracked)
        }


def downtime_by_device(now=None):
    """Evicted seconds per device over the availability window (open
    evictions accrue up to `now`)."""
    now = time.monotonic() if now is None else now
    with _lock:
        trans = list(_transitions)
        open_evict = dict(_evicted)
    down = {}
    opened = {}
    for kind, key, t in trans:
        if kind == "evict":
            opened.setdefault(key, t)
        elif kind == "restore" and key in opened:
            down[key] = down.get(key, 0.0) + (t - opened.pop(key))
    for key, t in open_evict.items():
        start = opened.get(key, t)
        down[key] = down.get(key, 0.0) + max(0.0, now - start)
    return {k: round(v, 6) for k, v in down.items()}


def availability_pct(now=None):
    """100 * (1 - evicted device-seconds / (tracked devices * window));
    100.0 while no window is open (no mesh registered) or no device is
    tracked."""
    now = time.monotonic() if now is None else now
    with _lock:
        t0 = _window_t0
        ntracked = len(_tracked)
    if t0 is None or not ntracked:
        return 100.0
    window = max(now - t0, 1e-9)
    total_down = sum(min(v, window)
                     for v in downtime_by_device(now).values())
    return max(0.0, 100.0 * (1.0 - total_down / (window * ntracked)))


# ------------------------------------------- the mesh: ROADMAP item 17
def effective_mesh(mesh):
    """The port runs no mesh: None passes through, a mesh raises."""
    if mesh is None:
        return None
    raise NotImplementedError(f"effective_mesh: the mesh rebuild "
                              f"{_NOT_PORTED}")


class CollectiveWatchdog(object):
    """The collective deadline watchdog (ROADMAP item 17, A16)."""

    def __init__(self):
        raise NotImplementedError(f"CollectiveWatchdog {_NOT_PORTED}")


def guarded_call(block, mesh, fn, args):
    """A guarded sharded dispatch (ROADMAP item 17, A16)."""
    raise NotImplementedError(f"guarded_call {_NOT_PORTED}")


def guarded(fn, mesh, block=None, name=None):
    """A guarded sharded dispatch wrapper (ROADMAP item 17, A16)."""
    raise NotImplementedError(f"guarded {_NOT_PORTED}")
