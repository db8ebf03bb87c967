"""Parameters carried over from the JAX package's plans, so that a run of
the port and a run of the JAX package use the same numbers.

The JAX plans keep their parameters in TPU layouts: `Beamform` stages the
weights as (re, im) planes transposed to (station, beam) and padded to
the 128-lane tile; `Pfb` folds the (ntap, nchan) prototype into an
(ntap, lanes) bank, each channel's column repeated per stream and
component; `Fdmt` holds its tables as numpy arrays; `Romein` keeps its
host plan state as numpy (`_pos_np`, `_kern_np`); `CorrelateBlock` its
gains as a flat complex table; `Flag` its carried (3, ncell) baseline
beside its [thresh, mad_factor, alpha]; `GainCal` its (ncell,) gains.
`carry_over` takes those numpy arrays and returns the port's arguments.
It needs nothing of the JAX package: the caller hands over numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.fdmt import plan_from_reference


def weights_from_planes(wr, wi, nbeam, nsp):
    """(S_p, B_p) f32 weight planes (stations on rows, padded) -> the
    (nbeam, nsp) complex64 weights."""
    wr, wi = np.asarray(wr), np.asarray(wi)
    if wr.shape != wi.shape or wr.shape[0] < nsp or wr.shape[1] < nbeam:
        raise ValueError(f"weight planes {wr.shape}/{wi.shape} do not hold "
                         f"{nsp} stations x {nbeam} beams")
    w = wr[:nsp, :nbeam].astype(np.float32) + \
        1j * wi[:nsp, :nbeam].astype(np.float32)
    return np.ascontiguousarray(w.T.astype(np.complex64))


def prototype_from_bank(bank, nchan):
    """A folded (ntap, nchan * rep) MAC bank -> the (ntap, nchan)
    prototype, checking that each channel's `rep` columns agree."""
    bank = np.asarray(bank)
    ntap, lanes = bank.shape
    if lanes % nchan:
        raise ValueError(f"bank of {lanes} lanes is not a fold of {nchan} "
                         f"channels")
    rep = lanes // nchan
    cols = bank.reshape(ntap, nchan, rep)
    if not (cols == cols[..., :1]).all():
        raise ValueError("bank columns of one channel differ: not a folded "
                         "prototype")
    return np.ascontiguousarray(cols[..., 0])


def carry_over(weight_planes=None, nbeam=None, nsp=None, pfb_bank=None,
               nchan=None, fdmt_tables=None, fdmt_geometry=None,
               romein_state=None, gains=None, flag_state=None,
               flag_params=None, cal_gains=None):
    """Numpy parameters of the JAX plans -> the port's arguments.

    weight_planes: (wr, wi) of a JAX `Beamform` (`_w_planes`), with the
    true nbeam and nsp; pfb_bank: a JAX `Pfb.staged_bank(...)` with the
    plan's nchan; fdmt_tables: the JAX `Fdmt`'s `_steps`, `_buckets`,
    `_init_perm`, `_init_chans_by_d` with fdmt_geometry = dict(nchan,
    max_delay, f0, df[, exponent]); romein_state: a JAX `Romein`'s host
    plan state (`_pos_np`, `_kern_np`); gains: the X-engine gains of the
    spec (a JAX `CorrelateBlock`'s `gains`); flag_state: a JAX `Flag`'s
    carried `_state`, with flag_params its [thresh, mad_factor, alpha];
    cal_gains: a JAX `GainCal`'s `gains`.  -> dict with 'weights'
    ((nbeam, nsp) complex64), 'coeffs' ((ntap, nchan) f32 values), 'fdmt'
    (an `Fdmt` plan), 'positions' ((2, ..., nvis) int32), 'kernels'
    (complex64, its broadcast shape kept), 'gains' (complex64),
    'flag_state' ((3, ncell) f32 tensor, for `Flag.load_state`),
    'flag_params' (dict of thresh, mad_factor, alpha, for
    `Flag.set_params`) and 'cal_gains' ((ncell,) complex64), for the
    parts given."""
    out = {}
    if flag_state is not None:
        st = np.array(flag_state, dtype=np.float32)
        if st.ndim != 2 or st.shape[0] != 3:
            raise ValueError(f"flag_state must be (3, ncell), got "
                             f"{st.shape}")
        out["flag_state"] = torch.from_numpy(st)
    if flag_params is not None:
        out["flag_params"] = dict(zip(
            ("thresh", "mad_factor", "alpha"),
            (float(v) for v in np.asarray(flag_params, np.float32))))
    if cal_gains is not None:
        out["cal_gains"] = np.asarray(cal_gains).astype(
            np.complex64).reshape(-1)
    if romein_state is not None:
        pos, kern = romein_state
        out["positions"] = np.asarray(pos).astype(np.int32)
        out["kernels"] = np.asarray(kern).astype(np.complex64)
    if gains is not None:
        out["gains"] = np.asarray(gains).astype(np.complex64)
    if weight_planes is not None:
        out["weights"] = weights_from_planes(*weight_planes, nbeam, nsp)
    if pfb_bank is not None:
        out["coeffs"] = prototype_from_bank(pfb_bank, nchan)
    if fdmt_tables is not None:
        out["fdmt"] = plan_from_reference(fdmt_tables, **fdmt_geometry)
    return out
