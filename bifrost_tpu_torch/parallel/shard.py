"""Label-driven sharding: map `_tensor` header axis labels onto mesh axes
(counterpart of bifrost_tpu/parallel/shard.py).

A block scope's `mesh=` setting names the Mesh; the optional `shard=`
setting maps header axis labels to mesh axis names (by default a label
shards over the mesh axis of the same name).  `partition_spec` returns
a plain tuple of mesh-axis names or None, one per leading axis, and
`named_sharding` binds it to its mesh.

A sharded gulp is one tensor on the ring's device plus its spec: a
shard is the view of that tensor the spec selects at a mesh position
(`shard_views`).  On a virtual mesh (mesh.virtual_devices) no bytes
move.  Where a position's device differs from the tensor's, its shard is
moved there with ``.to(device)`` and its result moved back; that path
needs more than one card and is not exercised on one.

Sharded residency: the spec rides the ring end to end.  The H2D copy
under a mesh scope stamps the gulp's {label: mesh axis} map into the
sequence header (`AXES_KEY`), generic device transforms carry it with
the header, and `ReadSpan.sharding` resolves it against the ring's mesh
and the span's labels and shape, so a transpose keeps the layout.

A kernel that needs a contiguous shard gets one through `contiguous`,
which counts the copies it makes (`copy_stats`): a 'freq' or 'stand'
shard of a (time, chan, station*pol) gulp is a strided view, and on a
virtual mesh each copy costs bandwidth a real mesh would not pay.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["partition_spec", "named_sharding", "shard_put", "mesh_axes_for",
           "NamedSharding", "ShardedTensor", "shard_views", "contiguous",
           "copy_stats", "reset_copy_stats", "span_sharding", "AXES_KEY"]

# The sequence-header key of a sharded stream's {label: mesh axis} map.
AXES_KEY = "_mesh_axes"

_copy_lock = threading.Lock()
_copies = {"count": 0, "nbyte": 0}


def mesh_axes_for(mesh, labels, shard=None, shape=None, strict=True):
    """-> list (len(labels)) of mesh-axis name or None per labeled axis.

    `shard` is a {label: mesh_axis_name} override; by default a label maps
    to the same-named mesh axis.  Each mesh axis is used at most once
    (first label wins).  When `shape` is given, an axis whose global size
    does not divide evenly by its mesh axis is left unsharded (the ragged
    fallback, intentional and silent).

    With `strict=True` an override naming a mesh axis the mesh does not
    have, or keyed by a label absent from `labels`, raises naming what is
    available.  `strict="axes"` validates only the mesh-axis names (the
    mode for callers that map a label subset against a scope-wide
    override); `strict=False` drops a bad override to unsharded.
    """
    shard = dict(shard) if shard else {}
    mesh_names = set(mesh.axis_names)
    sizes = mesh.shape
    if strict and shard:
        bad_axes = sorted(str(a) for a in shard.values()
                          if a is not None and a not in mesh_names)
        if bad_axes:
            raise ValueError(
                f"shard= override names mesh axis(es) {bad_axes} but the "
                f"mesh only has axes {sorted(mesh.axis_names)}; fix the "
                f"override, or pass strict=False for the intentional "
                f"drop-to-unsharded fallback")
        label_set = set(labels or [])
        bad_labels = sorted(str(k) for k in shard if k not in label_set)
        if bad_labels and strict != "axes":
            raise ValueError(
                f"shard= override keys {bad_labels} name no axis label of "
                f"this stream (labels: {sorted(label_set)}); the "
                f"override would be silently ignored; fix the label, or "
                f"pass strict='axes'/strict=False for the intentional "
                f"fallback")
    used = set()
    out = []
    for i, lbl in enumerate(labels or []):
        axis = shard.get(lbl, lbl if lbl in mesh_names else None)
        if axis is not None and (axis not in mesh_names or axis in used):
            axis = None
        if axis is not None and shape is not None and \
                (i >= len(shape) or shape[i] % sizes[axis]):
            axis = None
        if axis is not None:
            used.add(axis)
        out.append(axis)
    return out


def partition_spec(mesh, labels, shard=None, shape=None, ndim=None,
                   strict=True):
    """The spec of an array whose leading axes carry `labels`: a tuple of
    mesh-axis names or None, padded with None (replicated) to `ndim`.
    `strict` per mesh_axes_for."""
    axes = mesh_axes_for(mesh, labels, shard, shape=shape, strict=strict)
    if ndim is not None:
        axes = (axes + [None] * ndim)[:ndim]
    return tuple(axes)


class NamedSharding(object):
    """A spec bound to its mesh (jax.sharding.NamedSharding's role):
    `mesh`, `spec` (tuple), `device_set` (the mesh's positions)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)
        for a in self.spec:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(f"spec {self.spec} names mesh axis {a!r} "
                                 f"the mesh lacks ({mesh.axis_names})")

    @property
    def device_set(self):
        return set(self.mesh.devices.flat)

    def slices(self, shape, flat):
        """The index (a tuple of slices) of position `flat`'s shard of an
        array of `shape`."""
        coords = dict(zip(self.mesh.axis_names, self.mesh.coords(flat)))
        sizes = self.mesh.shape
        out = []
        for dim, n in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                out.append(slice(None))
                continue
            k = sizes[axis]
            if n % k:
                raise ValueError(f"axis {dim} of size {n} does not divide "
                                 f"over mesh axis {axis!r} of size {k}")
            step = n // k
            out.append(slice(coords[axis] * step,
                             (coords[axis] + 1) * step))
        return tuple(out)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh == self.mesh and other.spec == self.spec

    def __hash__(self):
        return hash((self.mesh, self.spec))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, spec={self.spec})"


def named_sharding(mesh, labels, shard=None, shape=None, ndim=None,
                   strict=True):
    return NamedSharding(mesh, partition_spec(mesh, labels, shard,
                                              shape=shape, ndim=ndim,
                                              strict=strict))


class ShardedTensor(object):
    """A tensor and its sharding: the global `data` on one device, laid
    out over `sharding.mesh` by `sharding.spec`."""

    __slots__ = ("data", "sharding")

    def __init__(self, data, sharding):
        self.data = data
        self.sharding = sharding

    @property
    def device(self):
        return self.data.device

    def shard(self, flat):
        """Position `flat`'s shard: a view of `data`."""
        return self.data[self.sharding.slices(self.data.shape, flat)]

    def __array__(self, dtype=None):
        a = self.data.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def shard_put(x, mesh, labels, shard=None, strict=True):
    """Lay `x` (a tensor, or a host array, which lands on the mesh's first
    position's device) out over `mesh` by its axis labels -> a
    ShardedTensor.  No bytes move for a tensor: the layout is its spec."""
    if isinstance(x, ShardedTensor):
        x = x.data
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x)).to(
            mesh.devices.flat[0].device)
    ns = named_sharding(mesh, labels, shard, shape=tuple(x.shape),
                        ndim=x.dim(), strict=strict)
    return ShardedTensor(x, ns)


def shard_views(mesh, x, spec):
    """Every mesh position's shard of `x` (a tensor or ShardedTensor)
    under `spec` -> collective.ShardValues.  Positions that hold one
    replica (same slices, same device) share one view object, so an
    engine computes each distinct shard once."""
    from .collective import ShardValues
    if isinstance(x, ShardedTensor):
        x = x.data
    ns = NamedSharding(mesh, spec)
    seen = {}
    values = []
    for flat, pos in enumerate(mesh.devices.flat):
        sl = ns.slices(tuple(x.shape), flat)
        key = (tuple((s.start, s.stop) for s in sl), pos.device)
        v = seen.get(key)
        if v is None:
            v = x[sl]
            if v.device != pos.device:
                v = v.to(pos.device)
            seen[key] = v
        values.append(v)
    return ShardValues(mesh, values, ns.spec)


def contiguous(t):
    """`t` contiguous, counting the copy where one is made."""
    if t.is_contiguous():
        return t
    with _copy_lock:
        _copies["count"] += 1
        _copies["nbyte"] += t.numel() * t.element_size()
    return t.contiguous()


def copy_stats():
    """{count, nbyte} of the contiguous copies `contiguous` has made."""
    with _copy_lock:
        return dict(_copies)


def reset_copy_stats():
    with _copy_lock:
        _copies["count"] = _copies["nbyte"] = 0


def span_sharding(mesh, labels, axes, shape):
    """The NamedSharding of a span with header `labels` and `shape` whose
    stream carries the {label: mesh axis} map `axes`: each mapped label
    keeps its mesh axis where the span's extent divides over it (the
    ragged fallback otherwise)."""
    from .faultdomain import effective_mesh
    mesh = effective_mesh(mesh)
    sizes = mesh.shape
    spec = []
    used = set()
    for i, lbl in enumerate(labels):
        a = axes.get(lbl)
        if a is None or a not in sizes or a in used or \
                shape[i] % sizes[a]:
            a = None
        if a is not None:
            used.add(a)
        spec.append(a)
    spec += [None] * (len(shape) - len(spec))
    return NamedSharding(mesh, spec)
