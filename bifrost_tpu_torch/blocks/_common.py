"""Shared block helpers (counterpart of bifrost_tpu/blocks/_common.py, and
of the axis-role helper of bifrost_tpu/blocks/correlate.py:33-63)."""

from __future__ import annotations

import copy as _copy


def deepcopy_header(header):
    return _copy.deepcopy(header)


def store(ospan, result):
    """Store an op result into a span's tensor view (any space)."""
    ospan.data.copy_(result)


def integrate_chunks(run_engine, nframe, carry, nacc):
    """The integration discipline of the B/X engine blocks: split
    `nframe` input frames at integration boundaries and fold each
    sub-chunk's engine partial with an eager add.

    `run_engine(k0, k1)` computes the engine partial over frames
    [k0, k1); `carry` is ``(acc, nframe_integrated)`` with a None start
    (the first partial REPLACES the accumulator, so even -0.0 signs match
    a fresh integration).  -> ``(emitted accs, carry')``.  With an
    integration length that is a multiple of the gulp this is one
    whole-gulp engine call."""
    acc, integ = carry
    outs = []
    k0 = 0
    while k0 < nframe:
        k1 = min(nframe, k0 + nacc - integ)
        v = run_engine(k0, k1)
        acc = v if acc is None else acc + v
        integ += k1 - k0
        if integ >= nacc:
            outs.append(acc)
            acc, integ = None, 0
        k0 = k1
    return outs, (acc, integ)


# Header label synonyms accepted for the canonical (time, freq, station,
# pol) axis roles.
_ROLE_SYNONYMS = {
    "time": ("time",),
    "freq": ("freq", "chan", "channel"),
    "station": ("station", "stand", "ant", "antenna", "input"),
    "pol": ("pol", "polarisation", "polarization"),
}


def _canonical_permutation(labels):
    """-> (perm, role_labels): axis permutation taking `labels` order to
    (time, freq, station, pol), and the actual label spelling per role."""
    if labels is None or len(labels) != 4:
        raise ValueError(
            f"expected a 4-axis (time/freq/station/pol) tensor, got labels "
            f"{labels}")
    lowered = [str(lbl).lower() for lbl in labels]
    perm, role_labels = [], []
    for role, names in _ROLE_SYNONYMS.items():
        idx = next((i for i, lbl in enumerate(lowered) if lbl in names),
                   None)
        if idx is None:
            raise ValueError(f"no axis labelled like {role!r} in {labels}")
        perm.append(idx)
        role_labels.append(labels[idx])
    if sorted(perm) != [0, 1, 2, 3]:
        raise ValueError(f"ambiguous axis labels {labels}")
    return perm, role_labels
