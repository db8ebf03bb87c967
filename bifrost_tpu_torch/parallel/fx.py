"""The sharded FX engine step: channelize -> correlate + beamform + detect
over a ('time', 'freq') or ('time', 'freq', 'stand') mesh (counterpart of
bifrost_tpu/parallel/fx.py).

Layout:

- voltages x: (ntime, nchan, nstand, npol, 2) int8 (trailing (re, im)),
  sharded ('time', 'freq') on the leading axes (and 'stand' on the
  station axis with a station mesh axis);
- correlator: per-shard product over local time, psum over 'time':
  visibilities sharded over 'freq';
- beamformer: weights (nbeam, nstand*npol) replicated; per-shard beams,
  detected powers integrated over local time, psum over 'time';
- spectrometer: |X|^2 over local time and stations, psum over 'time'.

'freq' never needs a collective.  With a 'stand' axis, each shard holds
a station subset: partial complex beams psum over 'stand' before
detection (the coherent sum), the correlator all-gathers the right-hand
stations over 'stand' (visibilities come out sharded over ('freq',
'stand'): local rows i against all columns j), and the spectrum psums
over 'stand' and 'time'.

The JAX package computes the step with jnp (FFT and einsums outside any
Pallas kernel); here it is `torch.fft.fft` and complex `torch.einsum`
with TF32 off, shard by shard under the collective watchdog.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .collective import all_gather, psum
from .shard import shard_views

__all__ = ["make_fx_step", "fx_step_reference"]


def fx_step_reference(x, weights, nfine):
    """Single-device numpy reference of the FX step (golden for tests).

    x: (ntime, nchan, nstand, npol, 2) int8; weights: (nbeam, nstand*npol)
    complex.  Returns (vis, beam_pow, spec):
      vis:  (nchan*nfine_kept, nstand*npol, nstand*npol) complex64
      beam_pow: (nbeam, nchan*nfine_kept) float32
      spec: (nchan*nfine_kept,) float32
    where nfine_kept = nfine and fine channelization reshapes time ->
    (ntime//nfine, nfine) with an FFT over the fine axis.
    """
    xc = x[..., 0].astype(np.float32) + 1j * x[..., 1].astype(np.float32)
    ntime, nchan, nstand, npol = xc.shape
    nblock = ntime // nfine
    xf = xc[:nblock * nfine].reshape(nblock, nfine, nchan, nstand, npol)
    X = np.fft.fft(xf, axis=1)  # fine channelization
    # (nblock, nfine, nchan, nstand*npol) -> (nblock, nchanF, nsp)
    Xm = X.reshape(nblock, nfine * nchan, nstand * npol) if nchan == 1 else \
        X.transpose(0, 2, 1, 3, 4).reshape(nblock, nchan * nfine,
                                           nstand * npol)
    vis = np.einsum("tci,tcj->cij", np.conj(Xm), Xm).astype(np.complex64)
    beam = np.einsum("bi,tci->tcb", weights, Xm)
    beam_pow = (np.abs(beam) ** 2).sum(axis=0).T.astype(np.float32)
    spec = (np.abs(Xm) ** 2).sum(axis=(0, 2)).astype(np.float32)
    return vis, beam_pow, spec


def _channelize(x, nfine):
    """Local shard (ltime, lchan, lstand, npol, 2) int8 -> Xm (nblock,
    lchan*nfine, lstand*npol) complex64: an FFT over each block of
    `nfine` frames, channel-major."""
    xc = torch.complex(x[..., 0].float(), x[..., 1].float())
    ltime, lchan, lstand, npol = xc.shape
    nblock = ltime // nfine
    xf = xc[:nblock * nfine].reshape(nblock, nfine, lchan, lstand, npol)
    X = torch.fft.fft(xf, dim=1)
    return X.permute(0, 2, 1, 3, 4).reshape(nblock, lchan * nfine,
                                             lstand * npol)


def _vis(xm, xall):
    return torch.einsum("tci,tcj->cij", xm.conj(), xall)


def _beams(w, xm):
    return torch.einsum("bi,tci->tcb", w, xm)


def _detect(beam):
    return (beam.real * beam.real + beam.imag * beam.imag).sum(dim=0).T


def _spec(xm):
    return (xm.real * xm.real + xm.imag * xm.imag).sum(dim=(0, 2))


@functools.lru_cache(maxsize=64)   # (mesh, nfine) keys grow with eviction
# churn (every degraded mesh is a new key): bounded, and dropping an
# entry drops a closure only.
def _build_fx_step(mesh, nfine):
    stand = "stand" in mesh.axis_names

    def step(x, w):
        dev = mesh.devices.flat[0].device
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(w, torch.Tensor):
            w = torch.from_numpy(np.asarray(w, dtype=np.complex64))
        x = x.to(dev)
        w = w.to(dev, torch.complex64)
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        if stand:
            xs = shard_views(mesh, x, ("time", "freq", "stand"))
            # stand-major flatten: a station subset is a contiguous run
            # of the station*pol axis
            ws = shard_views(mesh, w, (None, "stand"))
        else:
            xs = shard_views(mesh, x, ("time", "freq"))
            ws = None
        Xm = xs.map(lambda v: _channelize(v, nfine))
        if stand:
            xall = all_gather(Xm, "stand", 2)
            vis = psum(Xm.zip_map(_vis, xall), "time") \
                .assemble(("freq", "stand", None))
            beams = psum(ws.zip_map(_beams, Xm), "stand")
            pw = beams.map(_detect)
            pw = psum(pw, "time").assemble((None, "freq"))
            sp = psum(psum(Xm.map(_spec), "stand"), "time") \
                .assemble(("freq",))
        else:
            vis = psum(Xm.map(lambda v: _vis(v, v)), "time") \
                .assemble(("freq", None, None))
            pw = psum(Xm.map(lambda v: _detect(_beams(w, v))), "time") \
                .assemble((None, "freq"))
            sp = psum(Xm.map(_spec), "time").assemble(("freq",))
        return vis, pw, sp

    return step


def make_fx_step(mesh, nfine=4, block=None):
    """-> fn(x, weights) running the sharded FX step on `mesh`.

    x: (ntime, nchan, nstand, npol, 2) int8 (numpy or a tensor), with
    ntime % (mesh 'time' size * nfine) == 0 and nchan % (mesh 'freq'
    size) == 0 (and nstand % 'stand' size with a station axis).
    Outputs, on the mesh's first device: vis (nchanF, nsp, nsp), beam
    powers (nbeam, nchanF), spectrum (nchanF,).

    Every call runs as a guarded sharded dispatch under the collective
    watchdog (faultdomain.guarded): with `mesh_collective_timeout_s` set
    a shard that never reaches a reduction surfaces as a ShardFault.
    `block` attaches the dispatch to a pipeline block's supervision."""
    from . import faultdomain
    return faultdomain.guarded(_build_fx_step(mesh, int(nfine)), mesh,
                               block=block, name="fx_step")
