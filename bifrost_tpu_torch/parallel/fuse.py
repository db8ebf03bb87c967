"""Deferred-reduction mesh execution: coalesce a sharded chain's
collectives down to one psum per emit boundary (counterpart of
bifrost_tpu/parallel/fuse.py).

The per-block mesh engines (blocks/correlate.py `_xengine_mesh`,
blocks/beamform.py `_bengine_mesh`) close every gulp with a psum over
the 'time' mesh axis.  The reductions these chains perform (visibility
integration, beam-power integration, the accumulate tail) are additive
over time, so the psum commutes with the cross-gulp accumulation: each
shard carries its local partial across every gulp (and across fused
chain constituents, pipeline.MeshFusedBlock) and the chain reduces once
when an output frame is emitted.  'freq' and 'beam' never need a
collective.  A deferred chain therefore runs zero collectives in its
per-gulp step and exactly one all-reduce at its emit (`collective_stats`
below counts them).  Station tensor parallelism is the exception: its
psum is a coherent sum that must precede detection, so it stays
per-gulp by construction (blocks/beamform.py).

Partial layout convention: a carried partial is a collective.ShardValues
whose local tensors carry one leading axis of length 1 (the JAX
package's leading shard axis of the reduction-axis mesh size, seen from
one shard).  `make_reduce` folds it with the single deferred psum and
returns the global tensor the immediate engines would have produced.
Partials accumulate with shape-strict adds (collective.strict_add), so a
mesh-geometry change under a carried partial (an eviction that
re-factored the mesh) faults loudly into the supervised restart instead
of mis-adding.

The audit: the JAX package compiles a function and counts the
collectives in its optimized HLO.  Here nothing is compiled: every
collective call counts itself (parallel/collective.py), and
`collective_stats(fn, *args)` runs `fn` once under a ledger and returns
the same schema, {count, bytes, ops} with the JAX op names.  It runs the
function (its kernels launch), where the JAX audit only compiles it.

Ordering: deferring changes the f32 summation association
(sum-over-gulps-then-shards vs sum-over-shards-then-gulps).  Integer
voltage streams (the int8 X-engine, small-integer test data) are exact
under any association, which is what the bitwise checks measure.
"""

from __future__ import annotations

from .collective import ShardValues, ledger, psum

__all__ = ["make_reduce", "collective_stats", "count_collectives",
           "deferred_enabled"]


def deferred_enabled():
    """Current value of the `mesh_defer_reduce` flag (config.py)."""
    from .. import config
    return bool(config.get("mesh_defer_reduce"))


def make_reduce(mesh, tax, tail_spec):
    """-> the emit-boundary reduction of a deferred chain: fn(partials)
    folds the partials' leading length-1 axis, psums over `tax` (exactly
    one collective when 'time' is sharded, none when `tax` is None) and
    assembles the (*tail_spec)-sharded result into one tensor.  A
    partial of another mesh geometry raises."""
    tail_spec = tuple(tail_spec)

    def reduce(partials):
        if not isinstance(partials, ShardValues) or partials.mesh != mesh:
            raise ValueError(
                f"make_reduce: partials of another mesh geometry "
                f"({getattr(getattr(partials, 'mesh', None), 'shape', None)}"
                f" vs {mesh.shape}): a stale partial after a re-factor")

        def fold(v):
            if v.shape[0] != 1:
                raise ValueError(f"make_reduce: a partial's leading axis "
                                 f"must be 1, got {tuple(v.shape)}")
            return v[0]
        r = psum(partials.map(fold, spec=tail_spec), tax)
        return r.assemble(tail_spec)
    return reduce


def collective_stats(fn, *args):
    """Run `fn(*args)` once and count its collectives -> {"count",
    "bytes", "ops"}: `count` the collective calls, `ops` per JAX op name
    ("all-reduce", "all-gather"), `bytes` the summed bytes of one
    member's result per call.  Guarded wrappers (faultdomain.guarded)
    are unwrapped, as the JAX audit unwraps them."""
    fn = getattr(fn, "__wrapped__", fn)
    with ledger() as led:
        fn(*args)
    return led.stats()


def count_collectives(fn, *args):
    """The collective count of one run of `fn(*args)`."""
    return collective_stats(fn, *args)["count"]
