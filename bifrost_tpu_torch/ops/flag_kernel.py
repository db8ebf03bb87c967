"""The RFI flagger's baseline walk: the hand-written CUDA kernel W1
(csrc/flag.cu) and its plain PyTorch version.

W1 replaces no Pallas kernel: the JAX plan walks its windows on the
device as one ``jax.lax.scan`` of its per-window step
(bifrost_tpu/ops/flag.py:257-281, the step at :176-233).  Here the
carry-free statistics of a segment of n m-frame windows come from one
batched pass (ops/flag.py `Flag._window_stats`), and the walk takes them:

- ``stats``: 'mad' (med, mad, cross): (n, ncell) window medians and MADs
  and the (n,) cross-cell median MAD; 'sk' (sk, mean): (n, ncell) each.
- ``state``: the carried (3, ncell) f32 rows [center, scale, warm].
- ``params``: (thresh, mad_factor, alpha) as f32 values (`Flag._params`).

and gives (bad (n, ncell) bool, fill rows (n, ncell) f32, state' (3,
ncell) f32), state' a fresh tensor (the caller's state is never written:
the fused group's carry step and supervised restarts hold on to it).

`flag_walk_plain` is the torch walk, a loop over the windows of (ncell,)
operations; `flag_walk` launches W1 for CUDA tensors (one launch, each
cell's recurrence walked by a thread) and runs the plain version only for
tensors on the CPU; any other device raises.  W1 rounds each operation on
its own in the plain version's order, so the two are bitwise equal on
every input.  `flag_walk.launches` counts W1's launches (and nothing
else).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build
from .dq_kernel import _device_check
from .stats import MAD_EPS, MAD_SIGMA

WARM_CAP = 2.0 ** 20
ALGOS = ("mad", "sk")


def _f32(v):
    return float(np.float32(v))


def _sk_band(m):
    """The SK acceptance half-band per threshold sigma of m-frame
    windows, as an f32 value."""
    return _f32(np.sqrt(4.0 / max(m, 2)))


def flag_walk_plain(stats, m, state, params, algo):
    """W1's plain version: the baseline recurrence over the n windows of
    `stats` (one segment of m-frame windows) from `state` -> (bad, fill,
    state') (module docstring)."""
    p_thresh, p_mad, a = params
    c_b, s_b, warm = state.unbind(0)
    if algo == "mad":
        med, mad, cross = stats
        cold = mad > p_mad * (cross + MAD_EPS)[:, None]
    else:
        sk, mean = stats
        skbad = (sk - 1.0).abs() > p_thresh * _sk_band(m)
    bads, fills = [], []
    for i in range(stats[0].shape[0]):
        warmed = warm > 0.0
        if algo == "mad":
            ref_c = torch.where(warmed, c_b, med[i])
            ref_s = torch.where(warmed, s_b, mad[i])
            bad = ((med[i] - ref_c).abs() >
                   p_thresh * (MAD_SIGMA * ref_s + MAD_EPS)) \
                | (mad[i] > p_mad * (ref_s + MAD_EPS)) \
                | (~warmed & cold[i])
            good = ~bad
            c_b = torch.where(good, ref_c + a * (med[i] - ref_c), ref_c)
            s_b = torch.where(good, ref_s + a * (mad[i] - ref_s), ref_s)
        else:
            ref_c = torch.where(warmed, c_b, mean[i])
            bad = skbad[i] | (warmed & ((mean[i] - ref_c).abs() >
                                        p_mad * (ref_c + MAD_EPS)))
            good = ~bad
            c_b = torch.where(good, ref_c + a * (mean[i] - ref_c), ref_c)
            s_b = sk[i]
        warm = torch.where(good, torch.clamp(warm + 1.0, max=WARM_CAP), warm)
        bads.append(bad)
        fills.append(ref_c)
    return torch.stack(bads), torch.stack(fills), torch.stack([c_b, s_b, warm])


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("flag")
        lib.flag_walk.argtypes = (
            [ctypes.c_int] + ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 2
            + [ctypes.c_void_p, ctypes.c_longlong] +
            [ctypes.c_void_p] + [ctypes.c_longlong] * 2 +
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 +
            [ctypes.c_float] * 7 + [ctypes.c_void_p])
        lib.flag_walk.restype = ctypes.c_int
        lib.flag_error_string.argtypes = [ctypes.c_int]
        lib.flag_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(stats, state, params, algo):
    """Refuse what W1 does not take -> (n, ncell, device)."""
    if algo not in ALGOS:
        raise ValueError(f"flag_walk: unknown algo {algo!r} (expected "
                         f"{'/'.join(ALGOS)})")
    names = ("med", "mad", "cross") if algo == "mad" else ("sk", "mean")
    if len(stats) != len(names) or len(params) != 3:
        raise ValueError(f"flag_walk: '{algo}' takes the statistics "
                         f"{names} and 3 parameters")
    tensors = list(stats) + [state]
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"flag_walk: statistics and state must be "
                            f"float32 tensors, got "
                            f"{getattr(t, 'dtype', type(t))}")
    if stats[0].dim() != 2 or stats[0].shape[0] < 1:
        raise ValueError(f"flag_walk: {names[0]} must be (n >= 1, ncell), "
                         f"got {tuple(stats[0].shape)}")
    n, ncell = stats[0].shape
    want = [(n, ncell)] * 2 + [(n,)] * (algo == "mad") + [(3, ncell)]
    for name, t, shape in zip(names + ("state",), tensors, want):
        if tuple(t.shape) != shape:
            raise ValueError(f"flag_walk: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    dev = stats[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"flag_walk: statistics and state must lie on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    return n, ncell, dev


def flag_walk(stats, m, state, params, algo):
    """W1 on the statistics' device: `flag_walk_plain`'s (bad, fill,
    state') from one launch (module docstring)."""
    n, ncell, dev = _check(stats, state, params, algo)
    if dev.type == "cpu":
        return flag_walk_plain(stats, m, state, params, algo)
    _device_check("flag_walk", stats[0])
    p_thresh, p_mad, a = params
    bad = torch.empty(n, ncell, dtype=torch.bool, device=dev)
    fill = torch.empty(n, ncell, dtype=torch.float32, device=dev)
    out = torch.empty(3, ncell, dtype=torch.float32, device=dev)
    s0, s1 = stats[0], stats[1]
    cross = stats[2] if algo == "mad" else None
    lib = _library()
    err = lib.flag_walk(
        ALGOS.index(algo), s0.data_ptr(), *s0.stride(), s1.data_ptr(),
        *s1.stride(), None if cross is None else cross.data_ptr(),
        0 if cross is None else cross.stride(0), state.data_ptr(),
        *state.stride(), bad.data_ptr(), fill.data_ptr(), out.data_ptr(), n,
        ncell, _f32(p_thresh), _f32(p_mad), _f32(a), _f32(MAD_SIGMA),
        _f32(MAD_EPS), _f32(p_thresh * _sk_band(m)), WARM_CAP,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("flag_walk launch failed: " +
                           lib.flag_error_string(err).decode())
    flag_walk.launches += 1
    return bad, fill, out


flag_walk.launches = 0
