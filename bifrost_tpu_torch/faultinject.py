"""Deterministic fault injection for supervision tests (counterpart of
bifrost_tpu/faultinject.py).

Every supervision scenario becomes a scripted interleaving: faults land
at exact call indices of exact seams, so a test asserts the one
interleaving its plan wrote.

    from bifrost_tpu_torch.faultinject import FaultPlan, InjectedFault

    plan = FaultPlan(seed=7)
    plan.raise_at("block.on_data", block="copy_1", nth=2)
    plan.wedge_at("ring.open", block="sink_2", nth=1,
                  release=release_event, entered=entered_event)
    plan.attach(pipe)
    try:
        pipe.run(supervise=sup)
    finally:
        plan.detach()

Sites (hooks cost one attribute load when no plan is attached):

- ``ring.reserve`` / ``ring.acquire`` / ``ring.open`` — on the calling
  block's thread just before the ring wait (`Ring._fault_hook`); a
  wedge there holds the thread outside the wait.
- ``block.on_data`` — the block's `on_data`, wrapped at attach.
- ``source.reserve`` — a reserve on a source block's own output ring.
- ``egress.stage`` / ``egress.drain`` — on an egress sink's thread just
  before a gulp is handed to / retired from its stager
  (`DeviceSinkBlock._egress_fault_hook`).
- ``udp.recv`` / ``capture.packet`` — through the `_udp_fault_hook`
  seam of a capture-shaped block (before a recv window / after one that
  ingested packets).
- ``collective.enter`` / ``shard.lost`` / ``shard.dispatch`` — on a mesh
  block's dispatching thread through its ``_collective_fault_hook`` seam
  (parallel/faultdomain.guarded_call), in that order for every guarded
  dispatch: ``shard.lost`` is the home of `lose_shard_at` (a `call` that
  marks a device lost, so the loss precedes the dispatch it afflicts),
  ``shard.dispatch`` fires just before the sharded call.  A wedge at
  ``shard.dispatch`` is a shard that never reaches the reduction: the
  collective watchdog (`mesh_collective_timeout_s`) declares a
  ShardFault and the wedge loop breaks on the block's ``_shard_abort``.

Actions: ``raise`` (`exc`, default InjectedFault), ``delay``
(`seconds`), ``wedge`` (block on a `threading.Event`, optionally
signalling `entered=` and stamping the heartbeat), ``interrupt`` (a
generation-counted ring interrupt) and ``call`` (`fn(site, block,
obj)`).  Every firing is appended to `plan.log` under a lock.

A point armed on a constituent's name fires on the fused group that
absorbed it (`constituent_names`): fuse first
(`pipe._fuse_device_chains()`, idempotent), then `plan.attach(pipe)`.
`detach()` restores every hook.
"""

from __future__ import annotations

import random
import threading
import time

__all__ = ["FaultPlan", "InjectedFault"]

SITES = ("ring.reserve", "ring.acquire", "ring.open", "block.on_data",
         "source.reserve", "egress.stage", "egress.drain",
         "udp.recv", "capture.packet",
         "collective.enter", "shard.dispatch", "shard.lost")
_COLLECTIVE_SITES = ("collective.enter", "shard.dispatch", "shard.lost")
ACTIONS = ("raise", "delay", "wedge", "interrupt", "call")


class InjectedFault(RuntimeError):
    """Default exception raised by a 'raise' fault point."""


def _match_names(block):
    """The names `block` answers to at a fault point: its own name plus,
    for a fused group (pipeline fusion compiler), every constituent's
    pre-fusion name — so a plan armed against a block that later fused
    still fires, attributed to the group."""
    name = getattr(block, "name", None)
    names = {name} if name is not None else set()
    names.update(getattr(block, "constituent_names", None) or ())
    return names


class _Point(object):
    """One armed injection point: a (site, block, ring) match plus an
    action, firing while its own match-counter is in [nth, nth+count)."""

    __slots__ = ("site", "block", "ring", "nth", "count", "action",
                 "kwargs", "seen", "fired")

    def __init__(self, site, action, block=None, ring=None, nth=0, count=1,
                 **kwargs):
        if site not in SITES:
            raise ValueError(f"unknown site {site!r} (one of {SITES})")
        if action not in ACTIONS:
            raise ValueError(f"unknown action {action!r} (one of {ACTIONS})")
        self.site = site
        self.action = action
        self.block = block      # block NAME (None = any block)
        self.ring = ring        # ring NAME (None = any ring)
        self.nth = int(nth)     # first matching call that fires (0-based)
        self.count = int(count) if count is not None else None  # None = all
        self.kwargs = kwargs
        self.seen = 0           # matching calls observed
        self.fired = 0          # times the action ran

    def matches(self, site, block_names, ring_name):
        if site != self.site:
            # "source.reserve" is sugar for a reserve on a source block's
            # output ring; the dispatcher passes the resolved alias too.
            return False
        # `block_names` covers the dispatching block's own name PLUS the
        # constituent names of a fused group (pipeline fusion compiler):
        # a point armed on a block that later fused fires on the group —
        # the faultinject-through-fusion contract.
        if self.block is not None and self.block not in block_names:
            return False
        if self.ring is not None and ring_name != self.ring:
            return False
        return True


class FaultPlan(object):
    """A deterministic, seeded schedule of fault injections.

    Arm points with `inject()` (or the `raise_at`/`delay_at`/`wedge_at`/
    `interrupt_at`/`call_at` sugar), `attach(pipeline)` to install the
    hooks, run the pipeline, `detach()` to restore.  `log` records every
    firing in order; `fired(site=, block=)` filters it.
    """

    def __init__(self, seed=0):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.points = []
        self.log = []
        self._lock = threading.Lock()
        self._seq = 0
        self._pipeline = None
        self._hooked_rings = []
        self._wrapped = []      # (block, original on_data)
        self._egress_hooked = []   # DeviceSinkBlocks with the hook set
        self._udp_hooked = []      # capture blocks with the hook set
        self._coll_hooked = []     # mesh blocks with the collective hook

    # -------------------------------------------------------------- arming
    def inject(self, site, action, block=None, ring=None, nth=0, count=1,
               **kwargs):
        if self._pipeline is not None:
            raise RuntimeError("arm every point before attach()")
        block = getattr(block, "name", block)
        ring = getattr(ring, "name", ring)
        self.points.append(_Point(site, action, block=block, ring=ring,
                                  nth=nth, count=count, **kwargs))
        return self

    def raise_at(self, site, exc=None, **where):
        return self.inject(site, "raise", exc=exc, **where)

    def delay_at(self, site, seconds, **where):
        return self.inject(site, "delay", seconds=seconds, **where)

    def wedge_at(self, site, release, entered=None, timeout=30.0,
                 stamp_heartbeat=False, **where):
        """Hold the calling thread at `site` until `release` (a
        threading.Event) is set, signalling `entered` (if given) first.
        `timeout` bounds the hold so a broken script cannot hang a test
        run.  `stamp_heartbeat=True` keeps the wedged block's heartbeat
        fresh while parked — use it when the wedge is scripting
        scaffolding rather than the failure under test."""
        return self.inject(site, "wedge", release=release, entered=entered,
                           timeout=timeout, stamp_heartbeat=stamp_heartbeat,
                           **where)

    def interrupt_at(self, site, target=0, **where):
        return self.inject(site, "interrupt", target=target, **where)

    def call_at(self, site, fn, **where):
        return self.inject(site, "call", fn=fn, **where)

    def lose_shard_at(self, site, device, **where):
        """Arm a `call` point that marks `device` lost in the fault-domain
        registry (parallel/faultdomain.mark_lost): a device dying on the
        virtual mesh, deterministically.  Armed at ``shard.lost``, it
        fires before the same dispatch's ``shard.dispatch``, so a wedge
        armed there with the same nth is attributed to `device`."""

        def fire(_site, _block, _obj):
            from .parallel.faultdomain import mark_lost
            mark_lost(device)

        return self.inject(site, "call", fn=fire, **where)

    # ----------------------------------------------------------- lifecycle
    def attach(self, pipeline):
        """Install the hooks on `pipeline`'s rings and blocks."""
        if self._pipeline is not None:
            raise RuntimeError("plan is already attached")
        self._pipeline = pipeline
        for ring in pipeline.rings:
            ring._fault_hook = self._ring_hook
            self._hooked_rings.append(ring)
        want_on_data = {p.block for p in self.points
                        if p.site == "block.on_data"}
        want_egress = {p.block for p in self.points
                       if p.site.startswith("egress.")}
        want_udp = {p.block for p in self.points
                    if p.site in ("udp.recv", "capture.packet")}
        want_coll = {p.block for p in self.points
                     if p.site in _COLLECTIVE_SITES}
        for b in pipeline.blocks:
            # Fused groups answer to their constituents' names too: a
            # plan armed on a block that later fused installs its hooks
            # on the group (the faultinject-through-fusion contract).
            names = _match_names(b)
            if want_egress and hasattr(b, "_egress_fault_hook") and \
                    (None in want_egress or names & want_egress):
                b._egress_fault_hook = self._egress_hook
                self._egress_hooked.append(b)
            if want_udp and hasattr(b, "_udp_fault_hook") and \
                    (None in want_udp or names & want_udp):
                b._udp_fault_hook = self._udp_hook
                self._udp_hooked.append(b)
            if want_coll and hasattr(b, "_collective_fault_hook") and \
                    (None in want_coll or names & want_coll):
                b._collective_fault_hook = self._collective_hook
                self._coll_hooked.append(b)
            if want_on_data and (None in want_on_data or
                                 names & want_on_data):
                # Remember whether on_data was an INSTANCE attribute so
                # detach restores exactly the pre-attach lookup (class
                # descriptor vs. instance override).
                had = "on_data" in b.__dict__
                prior = b.__dict__.get("on_data")
                b.on_data = self._wrap_on_data(b, b.on_data)
                self._wrapped.append((b, had, prior))
        return self

    def detach(self):
        for ring in self._hooked_rings:
            ring._fault_hook = None
        del self._hooked_rings[:]
        for b, had, prior in self._wrapped:
            if had:
                b.on_data = prior
            else:
                try:
                    del b.on_data
                except AttributeError:
                    pass
        del self._wrapped[:]
        for b in self._egress_hooked:
            b._egress_fault_hook = None
        del self._egress_hooked[:]
        for b in self._udp_hooked:
            b._udp_fault_hook = None
        del self._udp_hooked[:]
        for b in self._coll_hooked:
            b._collective_fault_hook = None
        del self._coll_hooked[:]
        self._pipeline = None
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()

    # ------------------------------------------------------------ dispatch
    def _block_for_current_thread(self):
        pipe = self._pipeline
        if pipe is None:
            return None
        ident = threading.get_ident()
        for b in pipe.blocks:
            owns = getattr(b, "owns_thread", None)
            if (owns(ident) if owns is not None
                    else getattr(b, "_thread_ident", None) == ident):
                return b
        return None

    def _ring_hook(self, site, ring):
        block = self._block_for_current_thread()
        sites = (site,)
        if site == "ring.reserve" and block is not None and \
                any(getattr(r, "base_ring", r) is ring
                    for r in getattr(block, "orings", []) or []) and \
                not getattr(block, "irings", None):
            sites = (site, "source.reserve")
        self._dispatch(sites, block, ring)

    def _egress_hook(self, site, block):
        self._dispatch((site,), block, block)

    def _udp_hook(self, site, block):
        self._dispatch((site,), block, block)

    def _collective_hook(self, site, block):
        self._dispatch((site,), block, block)

    def _wrap_on_data(self, block, orig):
        def on_data(*args, **kwargs):
            self._dispatch(("block.on_data",), block, block)
            return orig(*args, **kwargs)
        return on_data

    def _dispatch(self, sites, block, obj):
        block_name = getattr(block, "name", None)
        block_names = _match_names(block)
        ring_name = getattr(obj, "name", None) if obj is not block else None
        for point in self.points:
            hit = None
            for site in sites:
                if point.matches(site, block_names, ring_name):
                    hit = site
                    break
            if hit is None:
                continue
            with self._lock:
                n = point.seen
                point.seen += 1
                fire = n >= point.nth and (
                    point.count is None or n < point.nth + point.count)
                if fire:
                    point.fired += 1
                    self._seq += 1
                    self.log.append({
                        "seq": self._seq, "site": hit,
                        "block": block_name, "ring": ring_name,
                        "action": point.action, "n": n,
                        "t": time.monotonic()})
            if fire:
                self._run_action(point, hit, block, obj)

    def _run_action(self, point, site, block, obj):
        kw = point.kwargs
        action = point.action
        if action == "raise":
            exc = kw.get("exc")
            if exc is None:
                exc = InjectedFault(
                    f"injected fault at {site} "
                    f"(block={getattr(block, 'name', None)})")
            elif isinstance(exc, type):
                exc = exc(f"injected fault at {site}")
            raise exc
        if action == "delay":
            time.sleep(float(kw.get("seconds", 0.0)))
            return
        if action == "wedge":
            entered = kw.get("entered")
            if entered is not None:
                entered.set()
            release = kw.get("release")
            deadline = time.monotonic() + float(kw.get("timeout", 30.0))
            while release is not None and not release.is_set():
                if time.monotonic() >= deadline:
                    break  # bounded: a broken script must not hang a test
                if block is not None and \
                        getattr(block, "_shard_abort", None) is not None:
                    # The collective watchdog declared a ShardFault at
                    # this block: unpark, so the dispatch scope raises it
                    # (faultdomain.guarded_call).
                    break
                if kw.get("stamp_heartbeat") and block is not None:
                    block._heartbeat = time.monotonic()
                release.wait(0.02)
            return
        if action == "interrupt":
            ring = kw.get("ring", obj)
            ring = getattr(ring, "base_ring", ring)
            if hasattr(ring, "interrupt"):
                ring.interrupt(target=int(kw.get("target", 0)))
            return
        if action == "call":
            kw["fn"](site, block, obj)
            return

    # ------------------------------------------------------------- queries
    def fired(self, site=None, block=None):
        """Log entries filtered by site and/or block name."""
        with self._lock:
            return [e for e in self.log
                    if (site is None or e["site"] == site) and
                    (block is None or e["block"] == block)]
