"""The RFI flagger's window step: the hand-written CUDA kernels W1s (the
window statistics), W1m (the cross-cell median MAD) and W1 (the baseline
walk), csrc/flag.cu, and their plain PyTorch versions.

None replaces a Pallas kernel: the JAX plan walks its windows on the
device as one ``jax.lax.scan`` of its per-window step
(bifrost_tpu/ops/flag.py:257-281, the step at :176-233), which computes
each window's statistics and then the carried baseline.  Here a segment
of n m-frame windows takes W1s, for 'mad' W1m, then W1:

- `flag_stats` (W1s): pw, the segment's power viewed as (n, m, ncell)
  f32 (any strides) -> 'mad' (med, mad), the window medians and MADs;
  'sk' (sk, mean), each (n, ncell).  Any m (at least 2 for 'sk'): the
  register form up to `STATS_MAX_M` frames, the select form above
  (`stats_form`).  The medians select on total-order keys (`_keys`:
  -0.0 before +0.0, every NaN last and returned as 0x7fffffff), so
  `flag_stats_plain`, a sort of the same keys, is bitwise equal to W1s
  on every input; the SK sums run over the frames in the same tree of
  fan-out `FAN` in both (`_tree_sum`: frame order up to 32 frames).
- `flag_cross` (W1m): the (n, ncell) MAD rows -> the (n,) cross-cell
  median of each window.  One launch for rows of at most
  `CROSS_ROW_CELLS` cells (a block a row), three for each
  `CROSS_GRID_ROWS` rows above (`cross_form`).  Its plain version is
  `stats.median` (a `torch.sort`); MADs are non-negative or NaN, whose
  keys order as the floats, so the two are bitwise equal where the
  median is a number (a NaN median comes back as 0x7fffffff from W1m,
  as the sorted NaN from the plain version).
- `flag_walk` (W1): ``stats`` 'mad' (med, mad, cross) with cross the (n,)
  cross-cell median MAD, or 'sk' (sk, mean); ``state`` the carried (3,
  ncell) f32 rows [center, scale, warm]; ``params`` (thresh,
  mad_factor, alpha) as f32 values (`Flag._params`) -> (bad (n, ncell)
  bool, fill rows (n, ncell) f32, state' (3, ncell) f32), state' a fresh
  tensor (the caller's state is never written: the fused group's carry
  step and supervised restarts hold on to it).  Its form is chosen here
  by n (`walk_form`): the shared-memory ring for n > 1, one window a
  thread a cell (four cells a thread where strides and alignment allow)
  for n == 1.  `flag_walk_plain` is the torch walk, a loop over the
  windows of (ncell,) operations; W1 rounds each operation on its own in
  its order, so the two are bitwise equal on every input.

Each wrapper launches its kernel for CUDA tensors and runs the plain
version only for tensors on the CPU; any other device raises.
`flag_stats.launches`, `flag_cross.launches` and `flag_walk.launches`
count the kernel launches (and nothing else); `flag_stats.
select_launches` those of the select form, `flag_walk.vector_launches`
those of the four-cell form.
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from .. import build
from .dq_kernel import _device_check
from .stats import MAD_EPS, MAD_SIGMA, median

WARM_CAP = 2.0 ** 20
ALGOS = ("mad", "sk")
_SOURCE = (build.CSRC / "flag.cu").read_text()


def _constant(name):
    """An int constant of csrc/flag.cu (edit it there only)."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _SOURCE).group(1))


STATS_MAX_M = _constant("kMaxM")        # W1s's register form's longest
FAN = _constant("kFan")                 # the SK sums' tree fan-out
CROSS_ROW_CELLS = _constant("kCrossRowCells")
CROSS_GRID_ROWS = _constant("kGridRows")
CROSS_FORMS = ("row", "grid")
WALK_FORMS = ("ring", "one", "one4")
_TOP = 2 ** 31 - 1      # the key of a NaN


def _f32(v):
    return float(np.float32(v))


def _sk_band(m):
    """The SK acceptance half-band per threshold sigma of m-frame
    windows, as an f32 value."""
    return _f32(np.sqrt(4.0 / max(m, 2)))


def _sk_factor(m):
    """SK's (m + 1) / (m - 1), as a float (an f32 value where used)."""
    return (m + 1.0) / (m - 1.0)


def _keys(x):
    """The total-order int32 keys of f32 x (csrc/flag.cu key_of): the
    bits, the lower 31 flipped where the sign is set, INT_MAX for a
    NaN."""
    b = x.view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).masked_fill(x.isnan(),
                                                              _TOP)


def _values(k):
    return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)


def _middle(s, m):
    """The median of m sorted keys along dim 1: the middle value, or (lo
    + hi) / 2 of the two middle values for an even m."""
    hi = _values(s.select(1, m // 2))
    if m % 2 == 0:
        hi = (_values(s.select(1, m // 2 - 1)) + hi) / 2
    return hi


def _fold(v):
    """v (..., k, ncell) summed over its dim -2 in order."""
    s = v.select(-2, 0)
    for j in range(1, v.shape[-2]):
        s = s + v.select(-2, j)
    return s


def _tree_sum(x):
    """x (n, L, ncell) summed over dim 1 in W1s's tree (csrc/flag.cu):
    chunks of FAN (the last one shorter) each summed in order, then the
    chunk sums likewise, until one sum remains -> (n, ncell).  At most
    2 FAN operations a level."""
    while True:
        n, length, ncell = x.shape
        full = length - length % FAN
        parts = []
        if full:
            parts.append(_fold(x[:, :full].reshape(n, full // FAN, FAN,
                                                   ncell)))
        if full < length:
            parts.append(_fold(x[:, full:])[:, None])
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if x.shape[1] == 1:
            return x[:, 0]


def flag_stats_plain(pw, algo):
    """W1s's plain version: the statistics of the n m-frame windows of pw
    (n, m, ncell) f32 (module docstring)."""
    m = pw.shape[1]
    if algo == "mad":
        med = _middle(_keys(pw).sort(dim=1).values, m)
        dev = (pw - med[:, None]).abs()
        return med, _middle(_keys(dev).sort(dim=1).values, m)
    s1, s2 = _tree_sum(pw), _tree_sum(pw * pw)
    sk = _sk_factor(m) * (float(m) * s2 / (s1 * s1 + MAD_EPS) - 1.0)
    # A tensor divisor: on the card PyTorch divides by a Python number
    # through its reciprocal, which W1s's quotient is not.
    return sk, s1 / torch.full_like(s1, float(m))


def stats_form(m):
    """W1s's form for m-frame windows: 'registers' up to STATS_MAX_M
    frames, 'select' above."""
    return "registers" if m <= STATS_MAX_M else "select"


def flag_cross_plain(mad):
    """W1m's plain version: the median of each row of mad (n, ncell)
    f32 -> (n,)."""
    return median(mad, dim=1, keepdim=False)


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
        lib.flag_stats.argtypes = (
            [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_longlong] * 6 +
            [ctypes.c_void_p] * 2 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        lib.flag_stats.restype = ctypes.c_int
        lib.flag_walk.argtypes = (
            [ctypes.c_int] * 2 +
            ([ctypes.c_void_p] + [ctypes.c_longlong] * 2) * 2
            + [ctypes.c_void_p, ctypes.c_longlong] +
            [ctypes.c_void_p] + [ctypes.c_longlong] * 2 +
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 +
            [ctypes.c_float] * 7 + [ctypes.c_void_p])
        lib.flag_walk.restype = ctypes.c_int
        lib.flag_cross.argtypes = (
            [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_longlong] * 4 +
            [ctypes.c_void_p] * 3)
        lib.flag_cross.restype = ctypes.c_int
        lib.flag_cross_scratch_bytes.argtypes = []
        lib.flag_cross_scratch_bytes.restype = ctypes.c_longlong
        lib.flag_error_string.argtypes = [ctypes.c_int]
        lib.flag_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise(name, err):
    raise RuntimeError(f"{name} launch failed: " +
                       _library().flag_error_string(err).decode())


def _stats_check(pw, algo):
    """Refuse what W1s does not take -> (n, m, ncell)."""
    if algo not in ALGOS:
        raise ValueError(f"flag_stats: unknown algo {algo!r} (expected "
                         f"{'/'.join(ALGOS)})")
    if not isinstance(pw, torch.Tensor) or pw.dtype != torch.float32:
        raise TypeError(f"flag_stats: the power must be a float32 tensor, "
                        f"got {getattr(pw, 'dtype', type(pw))}")
    if pw.dim() != 3 or pw.shape[0] < 1:
        raise ValueError(f"flag_stats: the power must be (n >= 1, m, "
                         f"ncell), got {tuple(pw.shape)}")
    n, m, ncell = pw.shape
    low = 2 if algo == "sk" else 1
    if m < low:
        raise ValueError(f"flag_stats: '{algo}' takes windows of at least "
                         f"{low} frames, got {m}")
    return n, m, ncell


def flag_stats(pw, algo):
    """W1s on pw's device: `flag_stats_plain`'s statistics from one launch
    of the form `stats_form(m)` (module docstring)."""
    n, m, ncell = _stats_check(pw, algo)
    if pw.device.type == "cpu":
        return flag_stats_plain(pw, algo)
    _device_check("flag_stats", pw)
    out = [torch.empty(n, ncell, dtype=torch.float32, device=pw.device)
           for _ in range(2)]
    if ncell == 0:
        return tuple(out)
    err = _library().flag_stats(
        ALGOS.index(algo), pw.data_ptr(), *pw.stride(), n, m, ncell,
        out[0].data_ptr(), out[1].data_ptr(),
        _f32(_sk_factor(m)) if algo == "sk" else 0.0, _f32(MAD_EPS),
        torch.cuda.current_stream(pw.device).cuda_stream)
    if err:
        _raise("flag_stats", err)
    flag_stats.launches += 1
    flag_stats.select_launches += stats_form(m) == "select"
    return tuple(out)


flag_stats.launches = 0
flag_stats.select_launches = 0


def cross_form(ncell):
    """W1m's form for rows of ncell cells: 'row' (a block a row, one
    launch) up to CROSS_ROW_CELLS cells, 'grid' (a grid a row, three
    launches) above."""
    return "row" if ncell <= CROSS_ROW_CELLS else "grid"


def flag_cross(mad):
    """W1m on mad's device: `flag_cross_plain`'s cross-cell medians of the
    (n, ncell) f32 MAD rows (any strides) -> (n,) (module docstring)."""
    if not isinstance(mad, torch.Tensor) or mad.dtype != torch.float32:
        raise TypeError(f"flag_cross: the MADs must be a float32 tensor, "
                        f"got {getattr(mad, 'dtype', type(mad))}")
    if mad.dim() != 2 or mad.shape[0] < 1 or mad.shape[1] < 1:
        raise ValueError(f"flag_cross: the MADs must be (n >= 1, ncell >= "
                         f"1), got {tuple(mad.shape)}")
    if mad.device.type == "cpu":
        return flag_cross_plain(mad)
    _device_check("flag_cross", mad)
    n, ncell = mad.shape
    out = torch.empty(n, dtype=torch.float32, device=mad.device)
    form = cross_form(ncell)
    lib = _library()
    scratch = None
    if form == "grid":
        scratch = torch.empty(n * lib.flag_cross_scratch_bytes(),
                              dtype=torch.uint8, device=mad.device)
    err = lib.flag_cross(
        CROSS_FORMS.index(form), mad.data_ptr(), *mad.stride(), n, ncell,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(mad.device).cuda_stream)
    if err:
        _raise("flag_cross", err)
    flag_cross.launches += 1 if form == "row" else \
        3 * -(-n // CROSS_GRID_ROWS)
    return out


flag_cross.launches = 0


def walk_form(stats, state):
    """W1's form for these statistics and state: 'ring' for n > 1
    windows; for one window 'one4' (four cells a thread, 16-byte
    accesses) where the statistics and state rows are contiguous cells
    on 16-byte boundaries and ncell is a multiple of 4, else 'one'."""
    n, ncell = stats[0].shape
    if n > 1:
        return "ring"
    rows = [stats[0], stats[1], state, state[1], state[2]]
    if ncell % 4 == 0 and all(t.stride(-1) == 1 and t.data_ptr() % 16 == 0
                              for t in rows):
        return "one4"
    return "one"


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
    form = walk_form(stats, state)
    err = _library().flag_walk(
        ALGOS.index(algo), WALK_FORMS.index(form), s0.data_ptr(),
        *s0.stride(), s1.data_ptr(), *s1.stride(),
        None if cross is None else cross.data_ptr(),
        0 if cross is None else cross.stride(0), state.data_ptr(),
        *state.stride(), bad.data_ptr(), fill.data_ptr(), out.data_ptr(), n,
        ncell, _f32(p_thresh), _f32(p_mad), _f32(a), _f32(MAD_SIGMA),
        _f32(MAD_EPS), _f32(p_thresh * _sk_band(m)), WARM_CAP,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        _raise("flag_walk", err)
    flag_walk.launches += 1
    flag_walk.vector_launches += form == "one4"
    return bad, fill, out


flag_walk.launches = 0
flag_walk.vector_launches = 0
