"""Axis reductions (counterpart of bifrost_tpu/ops/reduce.py; reference
src/reduce.cu bfReduce).

The output shape matches the input's except along reduced axes, where
the output length divides the input's: reduced to 1 is a whole-axis
reduction, reduced by k a "scrunch" (reshape to (out, k), then reduce
the k).  Ops: sum, mean, min, max, stderr and their power variants
(|x|^2 first: real output from complex input).

The arithmetic follows the JAX op as XLA compiles it: a mean is the sum
times the f32 reciprocal of the count (XLA turns the division by a
constant into that product), integer input is lifted to f32 except under
a power op (x * x in the input type), complex min/max order
lexicographically (real part, then imaginary), and stderr is the
population deviation (ddof 0) over sqrt(count).  On integer-exact input
every op but stderr is then bitwise equal to the JAX op.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import finalize, prepare

REDUCE_OPS = ("sum", "mean", "min", "max", "stderr",
              "pwrsum", "pwrmean", "pwrmin", "pwrmax", "pwrstderr")


def _recip(n):
    """1 / n as the f32 constant XLA multiplies by."""
    return float(np.float32(1.0) / np.float32(n))


def _mean(x, ax, n):
    return x.sum(dim=ax) * _recip(n)


def _complex_extreme(x, ax, fn):
    """Lexicographic min/max of complex `x` over axes `ax` (jnp's order):
    the extreme real part, then among its ties the extreme imaginary."""
    keep = [d for d in range(x.dim()) if d not in ax]
    flat = x.permute(keep + list(ax)).reshape(
        [x.shape[d] for d in keep] + [-1])
    re, im = flat.real, flat.imag
    best = fn(re, dim=-1, keepdim=True)
    fill = math.inf if fn is torch.amin else -math.inf
    im = torch.where(re == best, im, torch.full_like(im, fill))
    return torch.complex(best[..., 0], fn(im, dim=-1))


def reduce_fn(x, ishape, oshape, op):
    """The reduction of `x` (logical form: a real or complex tensor of
    `ishape`) to `oshape` by `op`."""
    power = op.startswith("pwr")
    base = op[3:] if power else op
    if power:
        x = x.real * x.real + x.imag * x.imag if x.is_complex() else x * x
    elif not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    shape, red = [], []
    for di, do in zip(ishape, oshape):
        if di == do:
            shape.append(di)
        else:
            shape.extend([do, di // do])
            red.append(len(shape) - 1)
    x = x.reshape(shape)
    ax = tuple(red)
    n = int(np.prod([di // do for di, do in zip(ishape, oshape)]))
    if base == "sum":
        return x.sum(dim=ax)
    if base == "mean":
        return _mean(x, ax, n)
    if base in ("min", "max"):
        fn = torch.amin if base == "min" else torch.amax
        if x.is_complex():
            return _complex_extreme(x, ax, fn)
        return fn(x, dim=ax)
    if base == "stderr":
        dev = x - _mean(x, ax, n).reshape(
            [1 if i in ax else s for i, s in enumerate(shape)])
        pw = dev.real * dev.real + dev.imag * dev.imag if dev.is_complex() \
            else dev * dev
        return torch.sqrt(_mean(pw, ax, n)) / float(np.sqrt(np.float32(n)))
    raise ValueError(f"bad reduce op {base}")


def _validate(ishape, oshape):
    if len(ishape) != len(oshape):
        raise ValueError(f"reduce rank mismatch: {ishape} -> {oshape}")
    for di, do in zip(ishape, oshape):
        if do == 0 or di % do:
            raise ValueError(f"output dim {do} must divide input dim {di}")


def reduce_to(idata, oshape, op="sum"):
    """Reduce `idata` to a new tensor of `oshape` by `op`."""
    if op not in REDUCE_OPS:
        raise ValueError(f"Invalid reduce op: {op}")
    x = prepare(idata)
    ishape = tuple(int(s) for s in x.shape)
    oshape = tuple(int(s) for s in oshape)
    _validate(ishape, oshape)
    return reduce_fn(x, ishape, oshape, op)


def reduce(idata, odata, op="sum"):
    """Reduce `idata` into the tensor `odata` (reference reduce.py:50);
    its shape gives the reduction."""
    if odata is None:
        raise ValueError("reduce requires an output tensor (or use "
                         "reduce_to(idata, oshape, op))")
    return finalize(reduce_to(idata, tuple(odata.shape), op), out=odata)
