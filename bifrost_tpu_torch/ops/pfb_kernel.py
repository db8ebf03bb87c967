"""Polyphase-filterbank executor (counterpart of
bifrost_tpu/ops/pfb_pallas.py): the frame-axis FIR MAC on kernel K2
(ops/fir_kernel.py, csrc/fir.cu), then the nchan-point DFT as four real
matrix products.

The MAC stage is the per-lane FIR with frames as the time axis, decim=1
and lanes = (chan * nstream + stream) * ncomp + comp (`fold_frames`).
The kernel indexes the (ntap, nchan) prototype, one column per `nstream *
ncomp` lanes, instead of the JAX module's folded (ntap, lanes) bank
(`fold_bank`, kept for tests and callers that hold a bank).

The DFT stage is the JAX module's real-matmul quartet against f64-derived
f32 matrices (`_dft_mats`, copied verbatim with its bounded cache), in
its order: yre = zre.W_re, yim = zre.W_im, then yre -= zim.W_im and yim
+= zim.W_re.  It runs on `torch.matmul` in full f32 (TF32 off, the
reference's Precision.HIGHEST), as the JAX package leaves it to XLA
outside the pallas_call.  W is symmetric, so each frame's product is
W @ z[frame] with z[frame] (nchan, nstream): one matmul of the same shape
for every frame of every gulp, which keeps split gulps bitwise equal to
one long gulp whatever the BLAS does with other shapes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .fir_kernel import fir_tiled

_DFT_CACHE_SIZE = 16   # (nchan, nchan) f32 pairs are memory-heavy


@functools.lru_cache(maxsize=_DFT_CACHE_SIZE)
def _dft_mats(nchan):
    """(Wre, Wim) host f32 DFT matrices, derived in f64: W[k, q] =
    exp(-2j pi k q / nchan).  Cached bounded (module docstring)."""
    k = np.arange(nchan, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(k, k) / nchan
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


def fold_frames(re, im, nchan):
    """Fold (ntime, nstream) component planes into the MAC stage's
    (nframes, lanes) layout: lane index = (chan * nstream + stream) *
    ncomp + comp, nframes = ntime // nchan.  `im=None` folds a real
    stream (ncomp=1).  The caller guarantees ntime % nchan == 0."""
    ntime, nstream = re.shape
    m = ntime // nchan
    if im is None:
        return re.reshape(m, nchan * nstream)
    return torch.stack([re, im], dim=-1).reshape(m, nchan * nstream * 2)


def fold_bank(coeffs, nstream, ncomp):
    """Host (ntap, nchan) prototype -> the folded (ntap, lanes) MAC bank
    matching `fold_frames`' lane order (each channel's tap repeats per
    stream and component)."""
    c = np.asarray(coeffs, dtype=np.float32)
    return np.ascontiguousarray(np.repeat(c, nstream * ncomp, axis=1))


def dft(z, wre, wim, nchan, nstream, ncomp, out=None):
    """The DFT stage: z (m, lanes) f32 MAC output, (wre, wim) the
    `_dft_mats` planes on z's device -> (m, nchan, nstream) complex64 (into
    `out` when given)."""
    m = z.shape[0]
    if z.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    zv = z.view(m, nchan, nstream, ncomp)
    zre = zv[..., 0].contiguous()
    zim = zv[..., 1].contiguous() if ncomp == 2 else None
    if out is None:
        out = torch.empty(m, nchan, nstream, dtype=torch.complex64,
                          device=z.device)
    for f in range(m):
        yre = torch.matmul(wre, zre[f])
        yim = torch.matmul(wim, zre[f])
        if zim is not None:
            yre = yre - torch.matmul(wim, zim[f])
            yim = yim + torch.matmul(wre, zim[f])
        torch.complex(yre, yim, out=out[f])
    return out


def pfb_tiled(xf, coeffs, state, wre, wim, nchan, nstream, ncomp,
              method="cuda", out=None):
    """PFB over folded frames `xf` (nframes, lanes), f32 or int8 (raw ci8
    storage folds to this layout as it lies), with the (ntap, nchan) f32
    prototype `coeffs` and carried (ntap-1, lanes) f32 `state` ->
    (y, new_state): y the complex64 channelized block (nframes, nchan,
    nstream), new_state the trailing ntap-1 frames.  `method` routes the
    MAC ('cuda': kernel K2 on the card; 'plain': its plain version); the
    DFT is shared, so the two are bitwise equal."""
    z, new_state = fir_tiled(xf, coeffs, state, decim=1,
                             rep=nstream * ncomp, method=method)
    return dft(z, wre, wim, nchan, nstream, ncomp, out=out), new_state
