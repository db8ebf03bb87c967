"""Collectives over a mesh's shards, and the ledger that counts them.

A single controller drives every position of a mesh, so a collective is
an explicit, deterministic reduction over the shards' tensors:

- `psum(values, axis)` sums, for each group of positions that differ
  only along mesh axis `axis`, the members' tensors in mesh order
  (ascending coordinate along `axis`, starting from the first member),
  with a shape-strict add; every member receives the group's sum.
- `all_gather(values, axis, dim)` concatenates a group's tensors along
  `dim` in mesh order;
- `halo(shards, nrow)` hands each of a group's consecutive shards the
  last `nrow` rows of the one before it (a FIR's history across time
  shards).

`ShardValues` holds one local tensor per mesh position; positions that
hold one replica share one tensor object, and a collective or a `map`
computes each distinct group or shard once.  A group of tensors on other
devices is reduced on its first member's device.  The reductions are
plain elementwise adds (no matmul, so no TF32 rounding can enter).

Every collective call counts itself, as one op under the JAX package's
(XLA's) name for it ("all-reduce", "all-gather", "collective-permute"),
with the bytes of one member's result (what the JAX package's HLO audit reads off
an SPMD program's collectives), into each open `ledger()` of the calling
thread and into the process totals (`totals()`).  parallel/fuse.py's
`collective_stats` runs a function under a ledger: the port's
replacement for the JAX package's compiled-HLO audit.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["ShardValues", "psum", "all_gather", "halo", "strict_add",
           "ledger", "totals", "reset_totals"]

_tls = threading.local()
_lock = threading.Lock()
_totals = {"count": 0, "bytes": 0, "ops": {}}


class Ledger(object):
    """Collective counts of one run: {count, bytes, ops: {op: count}}."""

    def __init__(self):
        self.count = 0
        self.bytes = 0
        self.ops = {}

    def add(self, op, nbyte):
        self.count += 1
        self.bytes += int(nbyte)
        self.ops[op] = self.ops.get(op, 0) + 1

    def stats(self):
        return {"count": self.count, "bytes": self.bytes,
                "ops": dict(self.ops)}


@contextlib.contextmanager
def ledger():
    """Count the collectives this thread runs in the body."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    led = Ledger()
    stack.append(led)
    try:
        yield led
    finally:
        stack.remove(led)


def _note(op, nbyte):
    for led in getattr(_tls, "stack", ()):
        led.add(op, nbyte)
    with _lock:
        _totals["count"] += 1
        _totals["bytes"] += int(nbyte)
        _totals["ops"][op] = _totals["ops"].get(op, 0) + 1


def totals():
    """The process's collective counts since the last `reset_totals`."""
    with _lock:
        return {"count": _totals["count"], "bytes": _totals["bytes"],
                "ops": dict(_totals["ops"])}


def reset_totals():
    with _lock:
        _totals["count"] = _totals["bytes"] = 0
        _totals["ops"] = {}


def strict_add(a, b):
    """a + b with equal shapes and dtypes required (no broadcasting): a
    partial carried across a mesh-geometry change faults here instead of
    being added in silently."""
    if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
        raise ValueError(
            f"shape-strict add: {tuple(a.shape)} {a.dtype} + "
            f"{tuple(b.shape)} {b.dtype} (a mesh geometry change under a "
            f"carried partial?)")
    return a + b


class ShardValues(object):
    """One local tensor per mesh position (`values[flat]`), with the spec
    that lays them out (`spec`, the tensors' axes over mesh axes)."""

    __slots__ = ("mesh", "values", "spec")

    def __init__(self, mesh, values, spec=()):
        if len(values) != mesh.size:
            raise ValueError(f"{len(values)} shard values for a mesh of "
                             f"{mesh.size} positions")
        self.mesh = mesh
        self.values = list(values)
        self.spec = tuple(spec)

    def distinct(self):
        """The distinct tensors, in mesh order of first appearance."""
        seen = set()
        out = []
        for v in self.values:
            if id(v) not in seen:
                seen.add(id(v))
                out.append(v)
        return out

    def map(self, fn, spec=None):
        """fn over each distinct shard (once per replica group) ->
        ShardValues with `spec` (default: this one's)."""
        done = {}
        out = []
        for v in self.values:
            r = done.get(id(v))
            if r is None:
                r = done[id(v)] = fn(v)
            out.append(r)
        return ShardValues(self.mesh, out,
                           self.spec if spec is None else spec)

    def zip_map(self, fn, other, spec=None):
        """fn(mine, other's) position by position (once per distinct
        pair) -> ShardValues; both must be of one mesh geometry."""
        if other.mesh != self.mesh:
            raise ValueError(
                f"shard values of two mesh geometries ({self.mesh.shape} "
                f"vs {other.mesh.shape}): a partial carried across a "
                f"re-factor")
        done = {}
        out = []
        for a, b in zip(self.values, other.values):
            key = (id(a), id(b))
            r = done.get(key)
            if r is None:
                r = done[key] = fn(a, b)
            out.append(r)
        return ShardValues(self.mesh, out,
                           self.spec if spec is None else spec)

    def add(self, other):
        """Shape-strict elementwise sum with another ShardValues of the
        same mesh (a carried partial and a gulp's)."""
        return self.zip_map(strict_add, other)

    def assemble(self, spec=None, device=None):
        """The global tensor these shards make up under `spec` (default:
        their own), on `device` (default: the first position's).  Axes of
        the mesh that `spec` does not name hold replicas: the first
        position's is taken."""
        spec = self.spec if spec is None else tuple(spec)
        mesh = self.mesh
        first = self.values[0]
        device = first.device if device is None else torch.device(device)
        sizes = mesh.shape
        named = [a for a in spec if a is not None]
        if not named:
            return first if first.device == device else first.to(device)
        shape = list(first.shape)
        for dim, a in enumerate(spec):
            if a is not None:
                shape[dim] *= sizes[a]
        out = torch.empty(shape, dtype=first.dtype, device=device)
        for flat, v in enumerate(self.values):
            coords = dict(zip(mesh.axis_names, mesh.coords(flat)))
            if any(coords[a] for a in mesh.axis_names if a not in named):
                continue
            sl = []
            for dim, n in enumerate(v.shape):
                a = spec[dim] if dim < len(spec) else None
                c = coords[a] if a is not None else 0
                sl.append(slice(c * n, (c + 1) * n) if a is not None
                          else slice(None))
            out[tuple(sl)] = v
        return out


def _groups(mesh, axis):
    """Position groups differing only along `axis`, each in ascending
    coordinate along it."""
    ai = mesh.axis_names.index(axis)
    groups = {}
    for flat in range(mesh.size):
        c = mesh.coords(flat)
        groups.setdefault(c[:ai] + c[ai + 1:], []).append(flat)
    return list(groups.values())


def _collective(values, axis, op, combine):
    mesh = values.mesh
    if axis not in mesh.axis_names:
        raise ValueError(f"{op} over mesh axis {axis!r}: the mesh has "
                         f"axes {mesh.axis_names}")
    out = [None] * mesh.size
    done = {}
    nbyte = 0
    for members in _groups(mesh, axis):
        tensors = [values.values[m] for m in members]
        key = tuple(id(t) for t in tensors)
        r = done.get(key)
        if r is None:
            r = done[key] = combine(tensors)
        nbyte = r.numel() * r.element_size()
        for m in members:
            dev = mesh.devices.flat[m].device
            out[m] = r if r.device == dev else r.to(dev)
    _note(op, nbyte)
    return ShardValues(mesh, out, values.spec)


def psum(values, axis):
    """Sum over mesh axis `axis` (None: no collective, `values` as is)."""
    if axis is None:
        return values

    def combine(tensors):
        acc = tensors[0]
        for t in tensors[1:]:
            acc = strict_add(acc, t if t.device == acc.device
                             else t.to(acc.device))
        return acc
    return _collective(values, axis, "all-reduce", combine)


def all_gather(values, axis, dim):
    """Concatenate along `dim` over mesh axis `axis` (tiled)."""
    if axis is None:
        return values

    def combine(tensors):
        dev = tensors[0].device
        return torch.cat([t if t.device == dev else t.to(dev)
                          for t in tensors], dim=dim)
    return _collective(values, axis, "all-gather", combine)


def halo(shards, nrow):
    """The halo exchange of consecutive shards along one mesh axis (in
    mesh order, each at least `nrow` rows of dim 0): -> [None, the last
    `nrow` rows of shard 0, of shard 1, ...], each on its receiver's
    device.  One "collective-permute"."""
    out = [None]
    for prev, cur in zip(shards[:-1], shards[1:]):
        if prev.shape[0] < nrow:
            raise ValueError(f"halo of {nrow} rows from a shard of "
                             f"{prev.shape[0]}")
        h = prev[prev.shape[0] - nrow:]
        out.append(h if h.device == cur.device else h.to(cur.device))
    if len(shards) > 1:
        _note("collective-permute", out[1].numel() * out[1].element_size())
    return out
