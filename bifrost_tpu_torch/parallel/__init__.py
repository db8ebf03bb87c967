"""bifrost_tpu_torch.parallel: multi-device execution over a Mesh
(counterpart of bifrost_tpu.parallel).

Gulps are sharded over a device mesh, each shard's kernels run on its
own position's device, and the cross-station reductions (correlation,
beamforming) ride explicit collectives (psum / all_gather) between the
shards, counted per call (collective.py).

Mesh axes (DSP spellings of the ML parallelism taxonomy):
- 'time'  — data parallelism over the gulp's time axis: each shard
  integrates a time slice; integrations combine with psum.
- 'freq'  — spectral parallelism: channels are independent through the
  whole FX chain, so this axis needs no collective.
- 'stand' — station tensor parallelism for beamforming: each shard holds
  a station subset; beams reduce with psum over 'stand' before
  detection.
- 'beam'  — beam parallelism for the B-engine: each shard forms its own
  beam subset from sharded weights; collective-free like 'freq'.

Deferred reduction (fuse.py): the chains' additive reductions commute
with cross-gulp accumulation, so the per-gulp steps carry per-shard
partials and the chain runs one psum per emit boundary
(`mesh_defer_reduce`, pipeline.MeshFusedBlock).

Fault domains (faultdomain.py): sharded dispatches run under a
collective watchdog (`mesh_collective_timeout_s`) that turns a wedged or
lost shard into a supervised ShardFault; eviction rebuilds the effective
mesh over the survivors, and availability accounting measures the
outage.

One card runs the virtual form: `make_mesh(devices=virtual_devices(8,
'cuda:0'))` gives 8 positions backed by one torch device, the port's
counterpart of the JAX package's host-device count.  A mesh of several
cards is the same code with one real device a position, untested here.
"""

from .mesh import make_mesh, device_mesh_shape, virtual_devices
from .fx import make_fx_step, fx_step_reference
from .shard import (partition_spec, named_sharding, shard_put,
                    mesh_axes_for)
from .fuse import make_reduce, collective_stats, count_collectives
from .faultdomain import (ShardFault, effective_mesh, evict, restore,
                          mark_lost, mark_restored, availability_pct,
                          shard_health)
from . import faultdomain

__all__ = ["make_mesh", "device_mesh_shape", "make_fx_step",
           "fx_step_reference", "partition_spec", "named_sharding",
           "shard_put", "mesh_axes_for", "make_reduce",
           "collective_stats", "count_collectives", "ShardFault",
           "effective_mesh", "evict", "restore", "mark_lost",
           "mark_restored", "availability_pct", "shard_health",
           "virtual_devices", "faultdomain"]
