"""Pipeline-graph fusion compiler (counterpart of bifrost_tpu/fuse.py):
plan runs of device blocks into fused groups, one block each.

At `Pipeline.run` the planner walks the block graph, finds the maximal
runs of fusable blocks and replaces each run with ONE block on one
thread and one CUDA stream, which runs its constituents' per-gulp
functions back to back on tensors: the rings between them, their span
bookkeeping and their threads are gone.  The JAX group compiles the run
into one XLA program; here each stage is the block's own eager torch
call, so a fused run launches the same kernels as the unfused one, as
many times.  Capturing a group's stages as CUDA Graphs is later work.

Rules, as the JAX planner's
---------------------------
``device_chain``
    A maximal run of fuse-scoped (``block_scope(fuse=True)``) device
    transforms with one reader each (transpose, fft, detect, reduce,
    fftshift, reverse, scrunch: any block with a ``device_kernel()``
    hook; an elementwise or local ``MapBlock`` too) becomes a
    :class:`FusedChainBlock`.  An H2D ``CopyBlock`` may
    start the run (the host gulp is copied to the card in the group) and
    an ``AccumulateBlock`` may end it, its integration carried by the
    group.  Gated on the ``pipeline_fuse`` config flag (default on; off
    keeps the unfused chain, the baseline the fused one is bitwise equal
    to).

``stateful_chain``
    The same run where members declare cross-gulp state through the
    fused-carry protocol, ``device_kernel_carry() -> step(x, carry,
    consts) -> (y, carry')`` with ``fused_carry_init()`` and
    ``fused_carry_consts()``: the PFB's (ntap-1)-spectrum tail, the
    flagger's baseline, the calibrator (a trivial carry), the FDMT's
    dispersion tail and a stencil map's ``noffset``-frame input history
    (a forward or unbounded map is refused, ``map_unbounded_index``).
    The FDMT trades its ring overlap for a carry of its last max_delay
    input frames that starts at zeros; the group
    drops its first ``fused_carry_warmup_nframe`` output frames per
    sequence, the frames the unfused overlap never emits, and does not
    compute a gulp whose whole output is warm-up (it advances the carry
    with ``fused_carry_advance``), so the fused stream is bitwise the
    unfused one and launches no extra kernel.  A lossy reader's skipped
    frames reset every carry and re-apply the warm-up.  Built as
    :class:`StatefulChainBlock`; same ``pipeline_fuse`` gate.

    Integrators (the B and X engines, ``BeamformBlock`` and
    ``CorrelateBlock``, marked by ``fused_carry_nframe_per_integration``)
    join as host-orchestrated stages: their step is the block's own
    engine over the frame chunks its ring reads would present, split at
    integration boundaries by ``blocks._common.integrate_chunks``.  They
    join only where the stage stream is chunked as the unfused ring
    reads would chunk it: the planner cuts the chain in front of an
    integrator preceded by a warm-up stage or another integrator, and
    refuses an integrator with an explicit ``gulp_nframe``
    (``gulp_pinned``).  A gulp on which an integrator emits nothing ends
    the chain there: the unfused blocks downstream get no gulp either.

A stage whose input is complex-integer ring storage (ci8 pairs or
packed ci4, from an H2D head or a device ring) takes the block's
``device_kernel_carry_raw`` form, as its unfused ``on_data`` reads
``ReadSpan.data_storage``.

Storage-form stages: every stage's input is what its ring read would
hand it, the ring's storage form, so a quantize stage
(``fused_output_form = "storage"``) feeds its successor as its ring
would, and an unpack may take packed storage from any predecessor (the
JAX group lifts packed H2D input in-program, so there an unpack must
follow a sub-byte quantize).  A quantize to a sub-byte REAL type folds
several values a byte, which the next stage's header shape cannot hold:
it may end a group, not extend one (``dtype_incompatible``).

``mesh_chain`` (applied first, bifrost_tpu/fuse.py:251-318)
    A mesh-dispatched compute block declaring the mesh-fusion protocol
    (``mesh_chain_plan``: the correlate and beamform blocks under a
    ``mesh=`` scope) plus its one-reader accumulate tail becomes a
    ``pipeline.MeshFusedBlock``: per-shard partials carried across every
    gulp and the constituent boundary, one psum per emitted frame.
    Gated on the ``mesh_defer_reduce`` config flag (off keeps the
    per-block, per-gulp-psum chain: ``mesh_defer_reduce_off``, or
    ``mesh_integrator`` for a B/X engine), both fuse-scoped, both rings
    on the card; a head without such a tail is refused
    (``mesh_integrator`` for a B/X engine, ``mesh_head_unfused``
    otherwise, ``multi_reader`` with two readers).

Under the ``strict_sync`` config flag nothing is fused by the device
rules: every block they consider gets the ``strict_sync`` reason and
runs on its own, synchronised each gulp.

Every block the planner considered and did not fuse carries its reason
(``REASONS``); ``Pipeline.fusion_report()`` returns the plan, and
:func:`apply` publishes it on the ``<pipeline>/fusion_plan`` ProcLog.

Supervision (bifrost_tpu/fuse.py:95-105): a group's supervise events
carry its ``constituents``; a constituent ``on_sequence`` fault names
the stage; a fault point armed on a constituent's name fires on the
group (faultinject.py); a bounded quiesce reports the group with its
constituents; and a supervised restart re-runs the group's
``on_sequence``, which resets every carry and the carried integration.
A fault on the group's ``fused_async`` worker surfaces on the group's
thread at its next hand-off and restarts the group: the worker finishes
the item it runs, the items behind it are dropped (their span holds let
go, as they read nothing), and the surfaced exception is cleared.
"""

from __future__ import annotations

import json
import warnings

from .pipeline import FusedTransformBlock

__all__ = ["FusedChainBlock", "StatefulChainBlock", "FusionPlan", "plan",
           "apply", "REASONS"]

# Refusal reasons the planner reports (fusion_report()["refused"]).
REASONS = {
    "not_transform": "not a transform block (sources/sinks anchor chains)",
    "no_fuse_scope": "no `fuse` scope setting on the block",
    "pipeline_fuse_off": "pipeline_fuse config flag is off",
    "mesh_defer_reduce_off": "mesh_defer_reduce config flag is off",
    "strict_sync": "strict_sync leaves nothing in flight; chains stay "
                   "per-block for the simplest timing",
    "unplanned_op": "no device_kernel()/planned-op executor to compose",
    "multi_output": "more than one output ring",
    "host_resident": "input or output ring is not device-resident",
    "multi_reader": "output ring has more than one reader",
    "cross_gulp_state": "carries cross-gulp state (gulp overlap / "
                        "filter history / integration accumulator) "
                        "without declaring the fused-carry protocol "
                        "(device_kernel_carry)",
    "mesh_integrator": "mesh-sharded integrator keeps its own "
                       "deferred-reduction mesh plan (whole-gulp "
                       "sharded engines)",
    "gulp_pinned": "explicit gulp_nframe on an integrator stage would "
                   "re-chunk the stream away from the unfused ring "
                   "reads (the fused bitwise-parity anchor)",
    "dtype_incompatible": "storage-form boundary the composed program "
                          "cannot reshape (sub-byte real dtype)",
    "map_unbounded_index": "map expression indexes the time axis "
                           "forward or unboundedly (x(i+k) / x(n-1-i)): "
                           "those frames are not gulp-resident, so the "
                           "stage runs per-gulp unfused",
    "singleton": "no fusable neighbor (a 1-block run gains nothing)",
    "mesh_head_unfused": "mesh compute head without a fusable "
                         "accumulate tail",
    "mesh_copy_head": "mesh-sharded H2D copy keeps its own "
                      "sharded-transfer logic",
}


def _ring_base(r):
    return getattr(r, "base_ring", r)


def _readers_map(pipeline):
    readers = {}
    for b in pipeline.blocks:
        for r in getattr(b, "irings", []) or []:
            readers.setdefault(id(_ring_base(r)), []).append(b)
    return readers


def _boundary_reshape_safe(dtype):
    """Can a stage output of this dtype feed the next stage's header
    reshape?  Sub-byte real storage folds 2+ elements per byte, so its
    element count no longer matches the header's shape."""
    from .DataType import DataType
    dt = DataType(dtype)
    if dt.nbit >= 8:
        return True
    return bool(dt.is_complex and dt.nbit == 4)


class FusionPlan(object):
    """The planner's decision record for one pipeline: fused groups and
    per-block refusal reasons.  Built by :func:`plan`, applied by
    :func:`apply`, served by ``Pipeline.fusion_report()``."""

    def __init__(self, pipeline):
        from . import config
        self.pipeline_name = pipeline.pname
        # {"name", "rule", "constituents", "ring_hops_eliminated"}
        self.groups = []
        self.refused = {}    # block name -> reason key
        self.flags = {
            "pipeline_fuse": bool(config.get("pipeline_fuse")),
            "mesh_defer_reduce": bool(config.get("mesh_defer_reduce")),
        }

    def note_group(self, name, rule, constituents, hops):
        self.groups.append({
            "name": name, "rule": rule,
            "constituents": list(constituents),
            "ring_hops_eliminated": int(hops)})

    def note_refusal(self, block, reason):
        assert reason in REASONS, reason
        self.refused[block.name] = reason

    @property
    def ring_hops_eliminated(self):
        return sum(g["ring_hops_eliminated"] for g in self.groups)

    def report(self):
        return {
            "pipeline": self.pipeline_name,
            "flags": dict(self.flags),
            "groups": [dict(g, constituents=list(g["constituents"]))
                       for g in self.groups],
            "refused": dict(self.refused),
            "ring_hops_eliminated": self.ring_hops_eliminated,
        }

    def publish(self):
        """Flatten onto the ``<pipeline>/fusion_plan`` ProcLog, with the
        JAX plan's keys."""
        from .proclog import ProcLog
        entry = {
            "pipeline_fuse": int(self.flags["pipeline_fuse"]),
            "mesh_defer_reduce": int(self.flags["mesh_defer_reduce"]),
            "groups": len(self.groups),
            "ring_hops_eliminated": self.ring_hops_eliminated,
            "refused": json.dumps(self.refused),
        }
        for i, g in enumerate(self.groups):
            entry[f"group{i}"] = json.dumps(
                {"name": g["name"], "rule": g["rule"],
                 "constituents": g["constituents"],
                 "ring_hops_eliminated": g["ring_hops_eliminated"]})
        ProcLog(f"{self.pipeline_name}/fusion_plan").update(entry)


# ------------------------------------------------------------- mesh rule
def _mesh_head_ok(b):
    return (hasattr(b, "mesh_chain_plan") and
            bool(b._lookup("fuse")) and
            b.bound_mesh is not None and
            len(getattr(b, "orings", [])) == 1 and
            getattr(b.orings[0], "space", None) == "cuda" and
            getattr(_ring_base(b.irings[0]), "space", None) == "cuda")


def _mesh_tail_ok(t):
    from .blocks.accumulate import AccumulateBlock
    return (isinstance(t, AccumulateBlock) and
            bool(t._lookup("fuse")) and
            t.dtype is None and
            len(getattr(t, "orings", [])) == 1 and
            getattr(t.orings[0], "space", None) == "cuda")


def _apply_mesh_rule(pipeline, fplan, build=True):
    """Collapse fuse-scoped mesh compute heads and their accumulate tails
    into MeshFusedBlocks, gated on ``mesh_defer_reduce``.  -> the ids of
    the blocks a ``build=False`` pass claimed (the device rule skips
    them)."""
    from . import config
    from .pipeline import MeshFusedBlock, _view_transforms
    enabled = bool(config.get("mesh_defer_reduce"))
    readers = _readers_map(pipeline)
    taken = set()
    for b in list(pipeline.blocks):
        if isinstance(b, MeshFusedBlock):
            # An earlier (idempotent) pass built this group.
            fplan.note_group(b.name, "mesh_chain", b.constituent_names, 1)
            continue
        if not _mesh_head_ok(b):
            continue
        if not enabled:
            fplan.note_refusal(b, "mesh_integrator" if _integrator_nacc(b)
                               else "mesh_defer_reduce_off")
            continue
        rs = readers.get(id(b.orings[0]), [])
        if len(rs) != 1:
            fplan.note_refusal(b, "multi_reader")
            continue
        if not _mesh_tail_ok(rs[0]):
            fplan.note_refusal(b, "mesh_integrator" if _integrator_nacc(b)
                               else "mesh_head_unfused")
            continue
        tail = rs[0]
        if not build:
            fplan.note_group(f"MeshFused_{b.name}+{tail.name}",
                             "mesh_chain", [b.name, tail.name], 1)
            taken.update((id(b), id(tail)))
            continue
        fused = MeshFusedBlock(b, tail, _view_transforms(tail.irings[0]))
        pipeline.blocks[pipeline.blocks.index(b)] = fused
        pipeline.blocks.remove(tail)
        fplan.note_group(fused.name, "mesh_chain", [b.name, tail.name], 1)
    return taken


# ----------------------------------------------------- device-chain rule
def _integrator_nacc(b):
    """Integration length when `b` is an integrator stage (a B/X engine
    whose cross-gulp state is an integration), else 0."""
    return int(getattr(b, "fused_carry_nframe_per_integration", 0) or 0)


def _stage_warmup(b):
    return int(getattr(b, "fused_carry_warmup_nframe", 0) or 0)


def _chain_member_refusal(b, strict):
    """Why `b` cannot join a device chain as an interior or last stage,
    or None when it can."""
    from .pipeline import MultiTransformBlock, TransformBlock
    from .blocks.copy import CopyBlock
    if not isinstance(b, TransformBlock) or isinstance(b, CopyBlock):
        return "not_transform"
    if not bool(b._lookup("fuse")):
        return "no_fuse_scope"
    if strict:
        return "strict_sync"
    custom = getattr(b, "fuse_refusal_reason", None)
    if custom is not None:
        return custom
    carries = hasattr(b, "device_kernel_carry")
    if not hasattr(b, "device_kernel") and not carries:
        return "unplanned_op"
    if carries and _integrator_nacc(b):
        # An integrator runs its engine on the frame chunks the unfused
        # ring reads would present; an explicit gulp_nframe re-chunks.
        if getattr(b, "bound_mesh", None) is not None:
            return "mesh_integrator"
        if getattr(b, "gulp_nframe", None):
            return "gulp_pinned"
    if len(getattr(b, "orings", [])) != 1:
        return "multi_output"
    if getattr(b.orings[0], "space", None) != "cuda" or \
            getattr(_ring_base(b.irings[0]), "space", None) != "cuda":
        return "host_resident"
    if type(b).define_input_overlap_nframe is not \
            MultiTransformBlock.define_input_overlap_nframe and \
            not carries:
        return "cross_gulp_state"
    return None


def _head_refusal(b, strict):
    """Why `b` cannot start a chain as an H2D copy head, or None."""
    from .blocks.copy import CopyBlock
    if not isinstance(b, CopyBlock):
        return "not_transform"
    if not bool(b._lookup("fuse")):
        return "no_fuse_scope"
    if strict:
        return "strict_sync"
    if not hasattr(b, "device_kernel"):
        return "unplanned_op"
    if getattr(b, "bound_mesh", None) is not None:
        return "mesh_copy_head"
    if len(getattr(b, "orings", [])) != 1 or \
            getattr(b.orings[0], "space", None) != "cuda" or \
            getattr(_ring_base(b.irings[0]), "space", None) not in \
            ("system", "cuda_host"):
        return "host_resident"
    return None


def _tail_ok(b):
    from .blocks.accumulate import AccumulateBlock
    return (isinstance(b, AccumulateBlock) and
            bool(b._lookup("fuse")) and
            len(getattr(b, "orings", [])) == 1 and
            getattr(b.orings[0], "space", None) == "cuda")


def _boundary_extends(b):
    """May the chain extend past `b`?  A stage handing on storage the
    next stage's header reshape cannot represent (a quantize to a
    sub-byte real type) may end a chain, not continue it."""
    if getattr(b, "fused_output_form", "logical") == "storage":
        return _boundary_reshape_safe(b.dtype)
    return True


def _apply_device_rule(pipeline, fplan, build=True, taken=()):
    """The device_chain and stateful_chain rules in one walk.  With
    ``build=False`` (:func:`plan`) the decisions are recorded and the
    pipeline is left alone; `taken` holds the ids of blocks a mesh pass
    claimed without building."""
    from . import config
    from . import device as _device
    from .pipeline import MeshFusedBlock, TransformBlock, _view_transforms
    from .blocks.copy import CopyBlock

    enabled = bool(config.get("pipeline_fuse"))
    strict = _device.needs_strict_sync()
    readers = _readers_map(pipeline)
    used = set(taken)
    used.update(id(b) for b in pipeline.blocks
                if isinstance(b, MeshFusedBlock))
    chains = []

    def fusable(b):
        return _chain_member_refusal(b, strict) is None

    for b in pipeline.blocks:
        if isinstance(b, FusedTransformBlock):
            # An earlier pass built this group (apply is idempotent).
            fplan.note_group(b.name, b.fusion_rule, b.constituent_names,
                             b.ring_hops_eliminated)
            used.add(id(b))
            continue
        if id(b) in used:
            continue
        if not (fusable(b) or _head_refusal(b, strict) is None):
            continue
        if not enabled:
            fplan.note_refusal(b, "pipeline_fuse_off")
            continue
        chain = [b]
        used.add(id(b))
        cur = b
        tail = None
        # An integrator's engine calls depend on the chunking, so it
        # joins only where the stage stream is chunked as the unfused
        # ring reads would chunk it: a warm-up stage (its drop shifts the
        # frame phase) or an earlier integrator (its emits re-time the
        # stream) upstream cuts the chain in front of it.
        chunk_exact = _stage_warmup(b) == 0 and not _integrator_nacc(b)
        while True:
            if not _boundary_extends(cur):
                break
            rs = readers.get(id(cur.orings[0]), [])
            if len(rs) != 1 or id(rs[0]) in used:
                break
            nxt = rs[0]
            if _tail_ok(nxt):
                tail = nxt
                used.add(id(tail))
                break
            if not fusable(nxt):
                break
            if _integrator_nacc(nxt) and not chunk_exact:
                break
            chain.append(nxt)
            used.add(id(nxt))
            if _stage_warmup(nxt) or _integrator_nacc(nxt):
                chunk_exact = False
            cur = nxt
        if len(chain) > 1 or tail is not None:
            chains.append((chain, tail))
        else:
            # Nothing adjacent could join: say why the walk stopped.
            rs = readers.get(id(b.orings[0]), [])
            if len(rs) > 1:
                fplan.note_refusal(b, "multi_reader")
            elif not _boundary_extends(b):
                fplan.note_refusal(b, "dtype_incompatible")
            else:
                fplan.note_refusal(b, "singleton")

    for chain, tail in chains:
        names = [c.name for c in chain] + \
            ([tail.name] if tail is not None else [])
        cls = StatefulChainBlock \
            if any(hasattr(c, "device_kernel_carry") for c in chain) \
            else FusedChainBlock
        if not build:
            fplan.note_group("Fused_" + "+".join(names), cls.fusion_rule,
                             names, len(names) - 1)
            continue
        # The group reads the first constituent's ring itself (its views
        # included); only the interior views are re-applied.
        transforms = [[]] + [_view_transforms(c.irings[0])
                             for c in chain[1:]]
        tail_transforms = _view_transforms(tail.irings[0]) \
            if tail is not None else None
        fused = cls(chain, transforms, tail, tail_transforms)
        pipeline.blocks[pipeline.blocks.index(chain[0])] = fused
        for c in chain[1:]:
            pipeline.blocks.remove(c)
        if tail is not None:
            pipeline.blocks.remove(tail)
        used.add(id(fused))
        fplan.note_group(fused.name, cls.fusion_rule,
                         fused.constituent_names,
                         fused.ring_hops_eliminated)

    # Fuse-scoped transforms that never joined a chain get their reason.
    for b in pipeline.blocks:
        if id(b) in used or b.name in fplan.refused:
            continue
        if isinstance(b, FusedTransformBlock) or \
                not isinstance(b, TransformBlock):
            continue
        if _tail_ok(b):
            # An accumulate with no chain to end: nothing upstream fused.
            fplan.note_refusal(
                b, "singleton" if enabled else "pipeline_fuse_off")
            continue
        reason = (_chain_member_refusal(b, strict)
                  if not isinstance(b, CopyBlock)
                  else _head_refusal(b, strict))
        if reason is not None and reason != "not_transform":
            fplan.note_refusal(b, reason)


# -------------------------------------------------------------- planner
def apply(pipeline, rules=("mesh_chain", "device_chain")):
    """Plan and apply fusion on `pipeline` (idempotent: groups from an
    earlier pass are recognised, never fused again) -> the
    :class:`FusionPlan`, also kept as ``pipeline._fusion_plan``.  Mesh
    chains fuse first."""
    fplan = FusionPlan(pipeline)
    if "mesh_chain" in rules:
        _apply_mesh_rule(pipeline, fplan)
    if "device_chain" in rules:
        _apply_device_rule(pipeline, fplan)
    pipeline._fusion_plan = fplan
    fplan.publish()
    return fplan


def plan(pipeline):
    """The decisions :func:`apply` would make, with no side effects: the
    block list is untouched and no group is built."""
    fplan = FusionPlan(pipeline)
    taken = _apply_mesh_rule(pipeline, fplan, build=False)
    _apply_device_rule(pipeline, fplan, build=False, taken=taken)
    return fplan


# ------------------------------------------------------ FusedChainBlock
class FusedChainBlock(FusedTransformBlock):
    """A planner-built run of stateless device transforms (module
    docstring, rule ``device_chain``): FusedTransformBlock plus the
    group's report metadata, the ``pipeline_fuse`` latch and the exact
    emit schedule."""

    fusion_rule = "device_chain"

    @property
    def constituent_names(self):
        names = [c.name for c in self.constituents]
        if self.tail is not None:
            names.append(self.tail.name)
        return names

    @property
    def ring_hops_eliminated(self):
        """One per adjacent constituent pair, the tail included."""
        return len(self.constituent_names) - 1

    def on_sequence(self, iseq):
        ohdr = super().on_sequence(iseq)
        # The fused topology was decided under this flag: a change lands
        # at the next Pipeline build, and mid-sequence is refused.
        self._hold_flag_latch("pipeline_fuse")
        self._sched_gulp = self.gulp_nframe or \
            iseq.header.get("gulp_nframe", 1)
        self._sched_full = None
        return ohdr

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        """Exact per-gulp emit schedule: the chain's output frames are
        arithmetic over its stage ratios, and the tail's integrations end
        at fixed chain-frame offsets."""
        g = self._sched_gulp
        if self._sched_full is None:
            self._sched_full = self._chain_out_nframes(g)
        nfr = self._nfr_cache.get(in_nframe)
        if nfr is None:
            nfr = self._nfr_cache[in_nframe] = \
                self._chain_out_nframes(in_nframe)
        if self.tail is None:
            return [nfr]
        nacc = self.tail.nframe
        phase = ((rel_frame0 // g) * self._sched_full) % nacc
        return [(phase + nfr) // nacc]


# ---------------------------------------------------- StatefulChainBlock
def _stage_segments(kinds):
    """Cut the stage list into segments, each holding at most one
    stateful stage, in last position: "plain" (stateless), "carry" (a
    threaded carry) or "integ" (an integrator, alone in its segment).
    The JAX group compiles each segment into one program and cuts at the
    stateful stages so that the compiler cannot re-contract arithmetic
    across them; here the cut marks where a carry is threaded.  -> list
    of (start, end, kind), kind that of the segment's last stage."""
    segs = []
    start = 0
    for i, k in enumerate(kinds):
        if k == "carry":
            segs.append((start, i + 1, "carry"))
            start = i + 1
        elif k == "integ":
            if start < i:
                segs.append((start, i, "plain"))
            segs.append((i, i + 1, "integ"))
            start = i + 1
    if start < len(kinds):
        segs.append((start, len(kinds), "plain"))
    return segs


def _segment_fn(group, stages, stateful, drop):
    """One segment's body over stage indices `stages`: each stage takes
    its input as its ring read would present it and puts its output as
    its ring would store it; a trailing stateful stage threads (carry,
    consts) and drops its `drop` leading warm-up frames.  A stage that
    would get no frames is not called: the chain ends there.  A carry
    stage whose whole output is warm-up advances its carry without
    computing (``fused_carry_advance``).  -> seg(x, carry, consts) ->
    (y or None, carry')."""
    last = stages[-1]

    def seg(x, carry=None, consts=()):
        for i in stages:
            x = group._take(i, x)
            if x is None:
                return None, carry
            fn = group._fns[i]
            if not (stateful and i == last):
                x = group._put(i, fn(x))
                continue
            c = group.constituents[i]
            if drop:
                nout = c.define_output_nframes(x.shape[group._in_fax[i]])[0]
                advance = getattr(c, "fused_carry_advance", None)
                if drop >= nout and advance is not None:
                    return None, advance(x, carry)
            y, carry = fn(x, carry, consts)
            if y is None:
                return None, carry
            fax = group._stage_out_frame_axes[i]
            y = group._put(i, y)
            if drop:
                y = y.narrow(fax, drop, y.shape[fax] - drop).contiguous()
            return (y if y.shape[fax] else None), carry
        return x, carry
    return seg


def _lift_step(step, dtype):
    """A logical-form carry step fed complex-integer ring storage (ci8
    and wider pairs, packed ci4): lifted to complex64 first."""
    import torch
    from .ops.runtime import staged_unpack

    def lifted(x, carry, consts):
        return step(torch.complex(*staged_unpack(x, dtype)), carry, consts)
    return lifted


class StatefulChainBlock(FusedChainBlock):
    """A fused run whose members carry cross-gulp state (module
    docstring, rule ``stateful_chain``): FusedChainBlock plus

    - per-constituent carries, initialised from ``fused_carry_init()`` at
      every sequence start and threaded through the stages' steps with
      their ``fused_carry_consts()``;
    - per-stage warm-up: the first ``fused_carry_warmup_nframe`` output
      frames of a stage are dropped once per sequence;
    - the frame-offset restage guard: a lossy reader's skipped frames
      reset every carry and re-apply the warm-up;
    - integrators as host-orchestrated stages running their blocks' own
      engines through ``integrate_chunks``;
    - an exact ``output_nframes_for_gulp`` that replays the per-stage
      ratio, warm-up and integration-phase walk the gulps execute.
    """

    fusion_rule = "stateful_chain"

    def _build_stage_fns(self):
        """The stages' functions: a carry-declaring constituent gives its
        step, in its raw form where its input is complex-integer ring
        storage."""
        fns, kinds, carry_blocks = [], [], []
        for i, c in enumerate(self.constituents):
            if not hasattr(c, "device_kernel_carry"):
                fns.append(c.device_kernel())
                kinds.append("plain")
                continue
            dt = self._in_dtypes[i]
            if dt.is_complex and dt.is_integer:
                raw = getattr(c, "device_kernel_carry_raw", None)
                fns.append(raw(str(dt)) if raw is not None else
                           _lift_step(c.device_kernel_carry(), dt))
            else:
                fns.append(c.device_kernel_carry())
            kinds.append("integ" if _integrator_nacc(c) else "carry")
            carry_blocks.append(c)
        self._stage_kinds = tuple(kinds)
        self._carry_blocks = tuple(carry_blocks)
        self._integ_nacc = tuple(_integrator_nacc(c) for c in carry_blocks)
        self._segments = _stage_segments(self._stage_kinds)
        return tuple(fns)

    def on_sequence(self, iseq):
        hdr = super().on_sequence(iseq)
        self._consts = tuple(tuple(c.fused_carry_consts())
                             for c in self._carry_blocks)
        self._carries = self._init_carries()
        self._warmups = tuple(_stage_warmup(c) for c in self._carry_blocks)
        # Walk state: (warm-up left, integration phase), one entry each
        # per carry stage.  Integrator phases cycle mod nacc, so the
        # schedule is periodic; the memo finds the cycle (_sched_state).
        st0 = (self._warmups, (0,) * len(self._carry_blocks))
        self._walk_state = st0
        self._carry_expect = None
        self._variants = {}
        self._sched_seq = [(st0, 0)]
        self._sched_seen = {st0: 0}
        self._sched_cycle = None
        # A group that starts at a carry stage reading a ci8 device ring
        # reads it in storage form; count those reads as the unfused
        # block counts its own (the consumed multiple of its stride).
        dt = self._in_dtypes[0]
        self._raw_head = self.constituents[0] \
            if self._stage_kinds[0] != "plain" and dt.is_complex and \
            dt.is_integer else None
        self._raw_reads = 0        # gulps read in raw int storage form
        self._raw_read_nbyte = 0   # bytes those reads covered
        return hdr

    def _init_carries(self):
        return tuple(c.fused_carry_init() for c in self._carry_blocks)

    def on_sequence_end(self, iseqs):
        # A trailing partial integration has no output slot: dropped, as
        # the unfused engine blocks drop it, and said so.
        for c, nacc, carry in zip(self._carry_blocks,
                                  (_integrator_nacc(c)
                                   for c in self._carry_blocks),
                                  self._carries):
            if nacc and carry[1]:
                warnings.warn(
                    f"{c.name}: dropping a trailing partial integration "
                    f"({carry[1]}/{nacc} frames) at sequence end",
                    stacklevel=1)

    # ------------------------------------------------- frame arithmetic
    def _stage_walk(self, state, n):
        """Walk `n` input frames through the stages' ratios, consuming
        warm-up and advancing integration phases from `state` -> (chain
        frames emitted, per-stage drops, new state): the one source of
        the emit schedule and of each gulp's drops."""
        wl, ph = list(state[0]), list(state[1])
        drops = []
        ci = 0
        for c, pre, kind in zip(self.constituents,
                                self._stage_pre_ratios,
                                self._stage_kinds):
            for g1, g0 in pre:
                n = n * g1 // g0
            if kind == "integ":
                nacc = self._integ_nacc[ci]
                p = ph[ci]
                n, ph[ci] = (p + n) // nacc, (p + n) % nacc
                drops.append(0)
                ci += 1
                continue
            n = c.define_output_nframes(n)[0]
            if kind == "carry":
                d = min(wl[ci], n)
                wl[ci] -= d
                n -= d
                drops.append(d)
                ci += 1
            else:
                drops.append(0)
        return n, tuple(drops), (tuple(wl), tuple(ph))

    def _sched_state(self, k):
        """(walk state, chain frames emitted) before gulp `k`, gulps
        0..k-1 full: memoised through the transient, closed-form once
        the state cycles."""
        seq = self._sched_seq
        g = self._sched_gulp
        while len(seq) <= k:
            if self._sched_cycle is not None:
                i0, period, dcum = self._sched_cycle
                q, r = divmod(k - i0, period)
                st, cum = seq[i0 + r]
                return st, cum + q * dcum
            st, cum = seq[-1]
            nfr, _, st2 = self._stage_walk(st, g)
            hit = self._sched_seen.get(st2)
            if hit is not None:
                self._sched_cycle = (hit, len(seq) - hit,
                                     cum + nfr - seq[hit][1])
                continue
            self._sched_seen[st2] = len(seq)
            seq.append((st2, cum + nfr))
        return seq[k]

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        """Exact per-gulp emit schedule: the walk the gulps execute."""
        st, cum = self._sched_state(rel_frame0 // self._sched_gulp)
        nfr = self._stage_walk(st, in_nframe)[0]
        if self.tail is None:
            return [nfr]
        nacc = self.tail.nframe
        return [(cum + nfr) // nacc - cum // nacc]

    # ------------------------------------------------------------ gulps
    def _segment(self, si, drop):
        """Segment `si`'s body for a given drop, built once a sequence."""
        key = (si, drop)
        seg = self._variants.get(key)
        if seg is None:
            a, b, kind = self._segments[si]
            a = max(a, 1 if self._head else 0)
            seg = self._variants[key] = _segment_fn(
                self, list(range(a, b)), kind != "plain", drop)
        return seg

    def _plan_gulp(self, ispan):
        # Frame-offset restage guard: a discontinuity (a lossy reader's
        # skipped frames) invalidates every carried history.  Guaranteed
        # readers are contiguous, so the exact schedule never sees it.
        foff = ispan.frame_offset
        if self._carry_expect is not None and foff != self._carry_expect:
            self._carries = self._init_carries()
            self._walk_state = (self._warmups,
                                (0,) * len(self._carry_blocks))
        self._carry_expect = foff + ispan.nframe
        if self._raw_head is not None:
            stride = int(getattr(self._raw_head, "fused_carry_stride", 1))
            self._raw_reads += 1
            self._raw_read_nbyte += (ispan.nframe - ispan.nframe % stride) \
                * ispan.tensor.frame_nbyte
        nfr, drops, self._walk_state = \
            self._stage_walk(self._walk_state, ispan.nframe)
        return nfr, drops

    def _run_chain(self, x, drops):
        carries = list(self._carries)
        ci = 0
        for si, (a, b, kind) in enumerate(self._segments):
            if b == 1 and self._head:
                continue                  # the H2D head alone: done
            if kind == "plain":
                x, _ = self._segment(si, 0)(x)
            else:
                x, carries[ci] = self._segment(si, drops[b - 1])(
                    x, carries[ci], self._consts[ci])
                ci += 1
            if x is None:
                break
        self._carries = tuple(carries)
        return x
