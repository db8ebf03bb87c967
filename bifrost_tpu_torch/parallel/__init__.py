"""bifrost_tpu_torch.parallel (counterpart of bifrost_tpu.parallel).

Only `faultdomain`'s device registry is ported: the lost/evicted device
sets, their transitions and listeners, and the availability accounting
that `service.Service` and `fleet.FleetScheduler` read.  The mesh
machinery of the JAX package (`mesh`, `shard`, `fx`, `fuse`, and
faultdomain's collective watchdog and mesh rebuild) is ROADMAP item 17
(A16).
"""

from . import faultdomain

__all__ = ["faultdomain"]
