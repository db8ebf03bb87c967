"""Mesh fault domains: the collective watchdog, shard eviction and
availability (counterpart of bifrost_tpu/parallel/faultdomain.py).

A sharded pipeline has a failure mode single-device supervision cannot
see: a wedged or lost shard stalls every peer at the next collective, so
one bad shard becomes a whole-mesh hang.  This module turns that into a
bounded, supervised, measured event:

- the collective watchdog: every sharded dispatch routed through
  `guarded_call` (pipeline.Block.mesh_dispatch, parallel.fx.make_fx_step)
  registers a deadline of `mesh_collective_timeout_s` (config.py; 0, the
  default, disables it).  A monitor thread declares an overdue dispatch
  a `ShardFault(device, block, gulp)`: stamped on the dispatching block
  (`block._shard_abort`, which also unparks a faultinject wedge holding
  the dispatch), reported to its Supervisor as a `shard_fault` event,
  and raised out of the dispatch, from where the supervised restart
  sheds the faulted gulp.  The suspected device comes from the lost set
  (`mark_lost`).  A port kernel does not hang, so on the card a wedge is
  the fault-injection spin at ``shard.dispatch``;
- shard eviction: `evict(device)` removes a device from every mesh's
  effective geometry.  `effective_mesh(mesh)`, which
  `BlockScope.bound_mesh` routes through, rebuilds the mesh over the
  survivors (`device_mesh_shape` over the same axis names), so a
  restarted block resolves the degraded mesh; an axis the survivors no
  longer divide falls back to shard.py's ragged replication.
  `Supervisor.on_block_fault` evicts when a ShardFault names a device,
  and `restore(device)` (the service's auto-restore, or an operator)
  returns it at the next dispatch;
- availability accounting over the devices of every guarded mesh.

A device is a string key (a mesh position's key, e.g. ``cuda:0/3`` of a
virtual mesh; a `torch.device`; an int index into the CUDA devices; or
any string: the fleet's chaos scripts use named fake devices).  The
registry holds:

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
  itemises it.  An eviction tracks its device, a guarded mesh tracks
  its positions, and the window opens at the first guarded mesh.

All registry state is module-global and thread-safe; `reset()` restores
a clean slate for tests and scenario harnesses (listeners stay).
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

class ShardFault(RuntimeError):
    """A sharded dispatch missed its collective deadline.  `device` is
    the suspected device key (from the lost set at declaration; None
    without attribution), `block` the dispatching block's name, `gulp`
    the input frame of the gulp in flight (`Block._loop_frame`)."""

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
_tracked = set()    # device keys ever seen in a guarded mesh or evicted
_window_t0 = None   # availability window start (first mesh registration)
_mesh_cache = {}    # (mesh, frozenset(evicted)) -> rebuilt mesh
_registered = set() # meshes already folded into _tracked
MAX_TRANSITIONS = 4096


def _dev_key(device):
    """Stable string key for a device: a string, an int CUDA index, a
    mesh position (its key) or a torch.device (its str)."""
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


# Bumped on every evict/restore/resize: while 0 no geometry has ever
# changed, and the per-gulp reads (effective_mesh, the realign scan) skip.
_evict_epoch = 0
# Evictions that followed a loss (mark_lost): only these become
# restorable when health returns.
_evict_lost = set()


def evict(device):
    """Take `device` out of service.  -> True where this call made the
    transition, False where it was evicted already (callers that book
    events key on the transition, so two cannot double-book one)."""
    global _evict_epoch
    key = _dev_key(device)
    with _lock:
        if key in _evicted:
            return False
        _evicted[key] = time.monotonic()
        _tracked.add(key)
        if key in _lost:
            _evict_lost.add(key)
        _note_transition("evict", key)
        _mesh_cache.clear()
        _evict_epoch += 1
    _fire_listeners("evict", key)
    return True


def restore(device):
    """Return an evicted `device` to service -> True where this call made
    the transition."""
    global _evict_epoch
    key = _dev_key(device)
    with _lock:
        if _evicted.pop(key, None) is None:
            return False
        _evict_lost.discard(key)
        _note_transition("restore", key)
        _mesh_cache.clear()
        _evict_epoch += 1
    _fire_listeners("restore", key)
    return True


def note_geometry_change(tag="resize"):
    """Record a change of device shares that is not an eviction or a
    restore (a fleet tenant resize): bump the evict epoch, so every
    guarded dispatch re-resolves its effective mesh and re-runs the
    realign scan, and fire the listeners."""
    global _evict_epoch
    with _lock:
        _mesh_cache.clear()
        _evict_epoch += 1
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
    """Clean slate: forget losses, evictions, transitions, tracked
    devices and rebuilt meshes."""
    global _window_t0, _evict_epoch
    with _lock:
        _lost.clear()
        _evicted.clear()
        del _transitions[:]
        _tracked.clear()
        _mesh_cache.clear()
        _registered.clear()
        _evict_lost.clear()
        _window_t0 = None
        _evict_epoch = 0


def transitions():
    """Copy of the (kind, device, monotonic stamp) transition ledger."""
    with _lock:
        return list(_transitions)


def _register_mesh(mesh):
    """Fold a guarded mesh's positions into the tracked set (the first
    registration opens the availability window)."""
    global _window_t0
    with _lock:
        if mesh in _registered:
            return
        if len(_registered) >= 64:
            _registered.clear()  # bounded; _tracked keeps the union
        _registered.add(mesh)
        for d in mesh.devices.flat:
            _tracked.add(str(d))
        if _window_t0 is None:
            _window_t0 = time.monotonic()


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


def effective_mesh(mesh):
    """`mesh` with the evicted devices removed, or `mesh` itself when no
    eviction touches it.  The survivors are re-factored with
    `device_mesh_shape` over the same axis names; an axis the survivor
    count no longer divides falls back to shard.py's ragged replication
    when specs are built.  Raises ShardFault when every device of the
    mesh is evicted.  Results are cached per (mesh, eviction set), so
    equal meshes share one rebuild."""
    if mesh is None:
        return None
    if _evict_epoch == 0:
        # No eviction ever: every per-gulp bound_mesh read lands here.
        return mesh
    with _lock:
        if not _evicted:
            return mesh
        evicted = frozenset(_evicted)
        cached = _mesh_cache.get((mesh, evicted))
    if cached is not None:
        return cached
    import numpy as np

    from .mesh import Mesh, device_mesh_shape

    devices = list(mesh.devices.flat)
    survivors = [d for d in devices if str(d) not in evicted]
    if len(survivors) == len(devices):
        out = mesh
    elif not survivors:
        raise ShardFault(reason="every device of the mesh is evicted",
                         device=sorted(evicted)[0])
    else:
        shape = device_mesh_shape(len(survivors), mesh.axis_names)
        arr = np.empty(len(survivors), dtype=object)
        arr[:] = survivors
        out = Mesh(arr.reshape(shape), mesh.axis_names)
    with _lock:
        if len(_mesh_cache) >= 64:
            _mesh_cache.clear()
        _mesh_cache[(mesh, evicted)] = out
    return out


# --------------------------------------------------- collective watchdog
class _Scope(object):
    """One in-flight guarded dispatch."""

    __slots__ = ("block", "mesh", "deadline", "gulp", "timeout_s", "fault")

    def __init__(self, block, mesh, deadline, gulp, timeout_s):
        self.block = block
        self.mesh = mesh
        self.deadline = deadline
        self.gulp = gulp
        self.timeout_s = timeout_s
        self.fault = None


class CollectiveWatchdog(object):
    """Monitor thread over in-flight sharded dispatches: an overdue scope
    is declared a ShardFault, stamped on the scope and the dispatching
    block (`_shard_abort`, which also unparks a faultinject wedge holding
    the dispatch), and reported to the block's Supervisor as a
    `shard_fault` event.  The monitor starts with the first scope and
    retires after a few idle seconds."""

    SCAN_INTERVAL_S = 0.02
    IDLE_SCANS = 250  # ~5 s with no sharded dispatch in flight

    def __init__(self):
        self._lock = threading.Lock()
        self._scopes = []
        self._thread = None
        self._stop = threading.Event()

    def enter(self, block, mesh, timeout_s, gulp=None):
        scope = _Scope(block, mesh, time.monotonic() + timeout_s, gulp,
                       timeout_s)
        with self._lock:
            self._scopes.append(scope)
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._scan_loop, name="mesh-watchdog",
                    daemon=True)
                self._thread.start()
        return scope

    def exit(self, scope):
        with self._lock:
            try:
                self._scopes.remove(scope)
            except ValueError:
                pass

    def _scan_loop(self):
        idle = 0
        while not self._stop.wait(self.SCAN_INTERVAL_S):
            with self._lock:
                scopes = list(self._scopes)
                if not scopes:
                    idle += 1
                    if idle > self.IDLE_SCANS:
                        self._thread = None
                        return
                    continue
            idle = 0
            now = time.monotonic()
            for scope in scopes:
                if scope.fault is None and now >= scope.deadline:
                    declared = self._declare(scope)
                    if declared is not None:
                        self._notify(*declared)

    def _declare(self, scope):
        """Stamp an overdue scope's fault, under the lock and only while
        the scope is still registered: a dispatch that completed (exit())
        between the scan's snapshot and now is never declared faulted
        after the fact.  -> (block, fault, timeout) to notify, or None."""
        mesh_devs = {str(d) for d in scope.mesh.devices.flat} \
            if scope.mesh is not None else None
        suspects = [d for d in lost_devices()
                    if mesh_devs is None or d in mesh_devs]
        fault = ShardFault(
            device=suspects[0] if suspects else None,
            block=getattr(scope.block, "name", None),
            gulp=scope.gulp,
            reason=f"collective deadline ({scope.timeout_s:g}s) exceeded")
        with self._lock:
            if scope not in self._scopes or scope.fault is not None:
                return None
            scope.fault = fault
            block = scope.block
            if block is not None:
                # Visible to the faultinject wedge loop before the
                # supervisor event, so a scripted wedge can never see the
                # event and miss the abort.
                block._shard_abort = fault
        return (scope.block, fault, scope.timeout_s)

    @staticmethod
    def _notify(block, fault, timeout_s):
        # Outside the lock: the supervisor runs user callbacks.
        sup = getattr(block, "_supervisor", None) \
            if block is not None else None
        if sup is not None:
            try:
                sup.record_shard_fault(block, fault, timeout_s=timeout_s)
            except Exception:  # noqa: BLE001 — never break the monitor
                pass


_watchdog = CollectiveWatchdog()


class _GuardHolder(object):
    """Stand-in block for guarded dispatches outside a pipeline
    (parallel.fx.make_fx_step callers): the abort flag and a name."""

    __slots__ = ("name", "_supervisor", "_shard_abort",
                 "_collective_fault_hook", "_loop_frame")

    def __init__(self, name):
        self.name = name
        self._supervisor = None
        self._shard_abort = None
        self._collective_fault_hook = None
        self._loop_frame = None


def _realign_args(mesh, args):
    """Re-lay sharded arguments committed under another geometry onto
    `mesh` before a dispatch: a ShardedTensor whose mesh is not `mesh`
    (a gulp committed before an eviction or a restore) keeps its spec
    where the new geometry divides it, else goes replicated (the ragged
    fallback).  Only the layout changes: the global tensor is the same
    one, so on a virtual mesh no bytes move.  Carried partials
    (ShardValues) are not realigned: their shape-strict add faults.
    Until the first eviction ever, the scan is one integer check."""
    if _evict_epoch == 0:
        return args
    from .shard import NamedSharding, ShardedTensor
    out = []
    changed = False
    for a in args:
        if isinstance(a, ShardedTensor) and a.sharding.mesh != mesh:
            sizes = mesh.shape
            spec = tuple(
                ax if ax is not None and ax in sizes and
                dim < a.data.dim() and a.data.shape[dim] % sizes[ax] == 0
                else None
                for dim, ax in enumerate(a.sharding.spec))
            a = ShardedTensor(a.data, NamedSharding(mesh, spec))
            changed = True
        out.append(a)
    return tuple(out) if changed else args


def guarded_call(block, mesh, fn, args):
    """Run one sharded dispatch under the collective watchdog.

    Fires the faultinject seams on the dispatching thread, in order:
    ``collective.enter`` at scope entry, ``shard.lost`` (the home of
    `call` actions that mark a device lost, so the loss precedes the
    dispatch it affects), then ``shard.dispatch`` just before the call;
    a wedge at ``shard.dispatch`` is a shard that never reaches the
    reduction.  With `mesh_collective_timeout_s` 0 (the default) the
    guard is inert beyond the hook loads.  Raises the declared
    ShardFault after the dispatch returns or the wedge is aborted."""
    from .. import config

    hook = getattr(block, "_collective_fault_hook", None)
    timeout = config.get("mesh_collective_timeout_s")
    if not timeout or timeout <= 0:
        if hook is not None:
            hook("collective.enter", block)
            hook("shard.lost", block)
            hook("shard.dispatch", block)
        return fn(*_realign_args(mesh, args))
    _register_mesh(mesh)
    block._shard_abort = None
    scope = _watchdog.enter(block, mesh, float(timeout),
                            gulp=getattr(block, "_loop_frame", None))
    try:
        if hook is not None:
            hook("collective.enter", block)
            hook("shard.lost", block)
            hook("shard.dispatch", block)
        out = fn(*_realign_args(mesh, args))
    finally:
        _watchdog.exit(scope)
    fault = scope.fault if scope.fault is not None \
        else getattr(block, "_shard_abort", None)
    if fault is not None:
        block._shard_abort = None
        raise fault
    return out


def guarded(fn, mesh, block=None, name=None):
    """Wrap `fn` so every call runs as a guarded sharded dispatch on
    `mesh` (the make_fx_step on-ramp).  `block` attaches the dispatch to
    a pipeline block's supervision; without one each call gets a fresh
    private holder for its abort flag (attributed to `name`), so
    concurrent callers of one wrapper cannot consume each other's
    faults."""
    name = name or "fx_step"

    def wrapper(*args):
        holder = block if block is not None else _GuardHolder(name)
        return guarded_call(holder, mesh, fn, args)

    wrapper.guard_name = name
    wrapper.__wrapped__ = fn
    return wrapper
