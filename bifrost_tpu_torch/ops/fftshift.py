"""fftshift over selected axes (counterpart of bifrost_tpu/ops/fftshift.py;
reference blocks/fftshift.py): torch.fft.fftshift / ifftshift."""

from __future__ import annotations

import torch

from .common import finalize, prepare


def fftshift(src, axes, dst=None, inverse=False):
    """Roll `axes` of `src` by half their length (ifftshift when
    `inverse`); into `dst` when given."""
    t = prepare(src)
    if isinstance(axes, int):
        axes = (axes,)
    axes = tuple(int(a) % t.dim() for a in axes)
    fn = torch.fft.ifftshift if inverse else torch.fft.fftshift
    return finalize(fn(t, dim=axes), out=dst)
