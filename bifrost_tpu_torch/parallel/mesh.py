"""Device meshes (counterpart of bifrost_tpu/parallel/mesh.py).

A `Mesh` is an ndarray of `MeshDevice`s with one name per axis, as a
jax.sharding.Mesh is.  Axis names carry the layout semantics
(parallel/__init__.py): 'time' reduces at integration boundaries only,
'freq' and 'beam' are collective-free end to end, 'stand' is station
tensor parallelism.  `device_mesh_shape` factors the device count near
balanced across the axes.

A mesh position is either a real device (``MeshDevice('cuda:1')``, key
``cuda:1``) or one of `n` virtual positions backed by one torch device
(`virtual_devices(n, 'cuda:0')`, keys ``cuda:0/0`` .. ``cuda:0/<n-1>``),
the port's counterpart of the JAX package's host-device count
(``--xla_force_host_platform_device_count``).  Every position runs its
own shard's kernels on its backing device, and the fault-domain registry
(faultdomain.py) marks, evicts and restores a position by its key, so a
virtual mesh of 8 on one card exercises every mesh semantic: layouts,
per-shard launches, collectives, deferred reduction, the watchdog and
eviction onto the survivors.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "MeshDevice", "device_mesh_shape", "make_mesh",
           "virtual_devices"]


def device_mesh_shape(n_devices, axis_names=("time", "freq")):
    """Factor n_devices into a near-balanced mesh shape."""
    if len(axis_names) == 1:
        return (n_devices,)
    best = (1, n_devices)
    f = 1
    while f * f <= n_devices:
        if n_devices % f == 0:
            best = (n_devices // f, f)
        f += 1
    if len(axis_names) == 2:
        return best
    if len(axis_names) == 3:
        # split the larger 2-D factor again: (a, b) -> (a', a'', b)
        a, b = best
        inner = device_mesh_shape(a, axis_names[:2])
        return (inner[0], inner[1], b)
    raise ValueError("only 1-D/2-D/3-D meshes supported here")


class MeshDevice(object):
    """One mesh position: the torch device that runs its shard's kernels
    and its stable string key (the device itself, or ``<device>/<i>`` for
    position i of a virtual mesh)."""

    __slots__ = ("device", "index", "key")

    def __init__(self, device, index=None):
        self.device = torch.device(device)
        self.index = index
        self.key = str(self.device) if index is None \
            else f"{self.device}/{int(index)}"

    def __str__(self):
        return self.key

    def __repr__(self):
        return f"MeshDevice({self.key!r})"

    def __eq__(self, other):
        return isinstance(other, MeshDevice) and other.key == self.key

    def __hash__(self):
        return hash(self.key)


def virtual_devices(n, device=None):
    """`n` distinct mesh positions backed by one torch device (default:
    the card), keyed ``<device>/0`` .. ``<device>/<n-1>``."""
    from ..device import resolve_device
    dev = resolve_device(device)
    return [MeshDevice(dev, i) for i in range(int(n))]


def _real_devices():
    if not torch.cuda.is_available():
        return []
    return [MeshDevice(torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


def _check_present(devices):
    """A CUDA position must name a card that is there."""
    ncuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in devices:
        if d.device.type == "cuda" and (d.device.index or 0) >= ncuda:
            raise ValueError(
                f"mesh device {d.key} requested but only {ncuda} CUDA "
                f"device(s) are available; for a mesh of virtual "
                f"positions on one card use "
                f"make_mesh(devices=virtual_devices(n, 'cuda:0'))")


class Mesh(object):
    """An ndarray of MeshDevices (`devices`) with `axis_names`.  Equal
    (and of equal hash) when the axis names, the shape and the device
    keys are, as jax meshes compare by content."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"duplicate mesh axis names {axis_names}")
        devs = [d if isinstance(d, MeshDevice) else MeshDevice(d)
                for d in devices.flat]
        keys = tuple(d.key for d in devs)
        if len(set(keys)) != len(keys):
            raise ValueError(f"a mesh position appears twice: {keys}")
        _check_present(devs)
        arr = np.empty(len(devs), dtype=object)
        arr[:] = devs
        self.devices = arr.reshape(devices.shape)
        self.axis_names = axis_names
        self._key = (axis_names, self.devices.shape, keys)

    @property
    def shape(self):
        """{axis name: size}, as jax's Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def coords(self, flat):
        """Mesh coordinates of flat position `flat` (row-major)."""
        return tuple(int(c) for c in np.unravel_index(flat,
                                                      self.devices.shape))

    def __eq__(self, other):
        return isinstance(other, Mesh) and other._key == self._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, "
                f"devices={list(self._key[2])})")


def make_mesh(n_devices=None, axis_names=("time", "freq"), shape=None,
              devices=None):
    """A Mesh over the first `n_devices` of `devices` (default: the CUDA
    devices there are).  Asking for more devices than exist raises,
    naming the count and the virtual form: a mesh of virtual positions on
    one card is asked for explicitly, ``devices=virtual_devices(n)``."""
    if devices is None:
        devices = _real_devices()
    devices = [d if isinstance(d, MeshDevice) else MeshDevice(d)
               for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"make_mesh: n_devices={n_devices} requested but only "
                f"{len(devices)} device(s) are available; for a virtual "
                f"mesh of {n_devices} positions on one card pass "
                f"devices=virtual_devices({n_devices}, 'cuda:0')")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices (no CUDA device is "
                         "available); pass devices=virtual_devices(n, "
                         "device)")
    if shape is None:
        shape = device_mesh_shape(len(devices), axis_names)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names)
