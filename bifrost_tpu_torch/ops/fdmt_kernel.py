"""FDMT merge step: the hand-written CUDA kernel (csrc/fdmt.cu) and its
plain PyTorch version.

Replaces bifrost_tpu/ops/fdmt_pallas.py::_shift_add_fn.  The kernel is
bound by HBM bytes; its design fuses the row gathers and the delayed
shift-add of the JAX scan body (bifrost_tpu/ops/fdmt.py:418-431) into one
pass over every slice of a batch (the JAX package's vmap over beams): a
thread owns four samples and walks a group of consecutive output rows,
which share their input rows (see the note in the source).

`merge_step` launches the kernel for a CUDA tensor and runs
`merge_step_plain` only for a tensor on the CPU; any other device
raises.  `merge_step.launches` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from .. import build


def merge_step_plain(state, rowA, rowB, delay, out=None):
    """out[..., r, t] = state[..., rowA[r], t] + (state[..., rowB[r],
    t - delay[r]] if rowB[r] >= 0 and t >= delay[r] else +0.0): the
    gather and shift-add of the JAX scan body, in its arithmetic order,
    on a (nrows_in, ntime) state or a (batch, nrows_in, ntime) batch of
    them."""
    ntime = state.shape[-1]
    rA, rB, dl = rowA.long(), rowB.long(), delay.long()
    a = state[..., rA, :]
    b = torch.where((rB >= 0)[:, None], state[..., rB.clamp(min=0), :], 0.0)
    src = torch.arange(ntime, device=state.device)[None, :] - dl[:, None]
    bs = torch.gather(b, -1, src.clamp(0, ntime - 1).expand(b.shape))
    return torch.add(a, torch.where(src >= 0, bs, 0.0), out=out)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("fdmt")
        lib.fdmt_merge_step.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_longlong] * 5 + [ctypes.c_void_p]
        lib.fdmt_merge_step.restype = ctypes.c_int
        lib.fdmt_error_string.argtypes = [ctypes.c_int]
        lib.fdmt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _rows_contiguous(t):
    """Whether each (rows, ntime) slice of `t` is contiguous (the batch
    stride of a 3-D `t` is free)."""
    return t.is_contiguous() if t.dim() == 2 or t.shape[0] <= 1 \
        else t[0].is_contiguous()


def _extent(t, stride):
    """[first, last + 1) byte addresses of a tensor's elements, from its
    strides (`stride`, read once by the caller)."""
    lo = t.data_ptr()
    shape = t.shape
    span = 1 + (shape[-2] - 1) * stride[-2] + (shape[-1] - 1) * stride[-1]
    if len(shape) == 3:
        span += (shape[0] - 1) * stride[0]
    return lo, lo + 4 * span


def merge_step(state, rowA, rowB, delay, out):
    """One FDMT merge step into `out`, (nrows, ntime) f32, or (batch,
    nrows, ntime) for a batched state.

    `state` is (nrows_in, ntime) f32, or (batch, nrows_in, ntime) (the
    executor passes the batched form, even for one slice; the 2-D form
    is one slice without a batch axis, for direct callers); each
    (rows, ntime) slice of `state` and `out` is contiguous, the batch
    stride free (a slice of a larger ping-pong buffer).  rowA/rowB/delay
    are (nrows,) int32 and contiguous, with every row they name below
    nrows_in (the plan checks its tables), rowB -1 for "no partner" and
    delays >= 0.  `out` must not overlap `state`."""
    dev = state.device
    if dev.type == "cpu":
        return merge_step_plain(state, rowA, rowB, delay, out=out)
    if dev.type != "cuda":
        raise ValueError(f"fdmt merge_step: unsupported device {dev}")
    shape, oshape = state.shape, out.shape
    dim = len(shape)
    nrows, ntime = oshape[-2], oshape[-1]
    if state.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError("fdmt merge_step: state and out must be float32")
    if dim not in (2, 3) or len(oshape) != dim or shape[-1] != ntime or \
            (dim == 3 and shape[0] != oshape[0]):
        raise ValueError(f"fdmt merge_step: state {tuple(shape)} "
                         f"does not match out {tuple(oshape)}")
    for name, tab in (("rowA", rowA), ("rowB", rowB), ("delay", delay)):
        if tab.dtype != torch.int32 or tab.shape != (nrows,) or \
                not tab.is_contiguous() or tab.device != dev:
            raise ValueError(f"fdmt merge_step: {name} must be a "
                             f"contiguous ({nrows},) int32 tensor on {dev}")
    if out.device != dev or not (_rows_contiguous(state) and
                                 _rows_contiguous(out)):
        raise ValueError("fdmt merge_step: state and out must be "
                         "contiguous tensors on one device")
    sst, ost = state.stride(), out.stride()
    (s0, s1), (o0, o1) = _extent(state, sst), _extent(out, ost)
    if s0 < o1 and o0 < s1:
        raise ValueError("fdmt merge_step: out overlaps state")
    lib = _library()
    # The current stream's raw handle: a merge step is launched 12 times
    # a gulp, and building a torch.cuda.Stream object for each launch
    # took a third of this wrapper's host time in a profile (PERF.md §6).
    err = lib.fdmt_merge_step(
        s0, o0, rowA.data_ptr(), rowB.data_ptr(), delay.data_ptr(),
        shape[0] if dim == 3 else 1, nrows, ntime,
        sst[0] if dim == 3 else 0, ost[0] if dim == 3 else 0,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError("fdmt merge_step launch failed: " +
                           lib.fdmt_error_string(err).decode())
    merge_step.launches += 1
    return out


merge_step.launches = 0
