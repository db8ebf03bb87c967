"""Interop with numpy and other frameworks (counterpart of
bifrost_tpu/interop.py; reference: ndarray's as_cupy/as_GPUArray and
test_interop.py's round trips).

The port's arrays are torch tensors, so `as_torch` and `from_torch` are
the bridges to numpy and to any DLPack producer, with the framework's
conventions: complex integers carry a trailing (re, im) axis, packed
sub-byte types are uint8 bytes; zero-copy wherever the memory allows
(`torch.from_numpy`, `torch.from_dlpack`, a tensor already in place).
The JAX package's `as_jax` has no counterpart: the port imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .DataType import DataType
from .memory import space_device
from .ndarray import asarray, storage_view, structured_to_pair

__all__ = ["as_numpy", "as_torch", "from_torch"]


def as_numpy(x):
    """Any array (tensor, numpy, DLPack producer) -> numpy on the host;
    a CPU tensor is viewed, not copied."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if not isinstance(x, np.ndarray) and hasattr(x, "__dlpack__"):
        return torch.from_dlpack(x).cpu().numpy()
    return np.asarray(x)


def as_torch(x):
    """Any array -> torch tensor: a tensor passes through, numpy is viewed
    (a structured complex-integer array as its (re, im) storage form), a
    DLPack producer is taken over where it lies."""
    if isinstance(x, torch.Tensor):
        return x
    if not isinstance(x, np.ndarray) and hasattr(x, "__dlpack__"):
        return torch.from_dlpack(x)
    a = np.asarray(x)
    if a.dtype.names is not None:
        a = structured_to_pair(a)
    return torch.from_numpy(np.ascontiguousarray(a))


def from_torch(t, dtype=None, space="system", device=None):
    """A torch tensor -> the port's array of `dtype` in `space` ('system',
    'cuda_host' or 'cuda'; `device` backs 'cuda', default this thread's).
    A complex tensor given a complex-integer `dtype` is rounded to its
    storage form; a tensor already in the space is returned as it is."""
    t = t.detach()
    if dtype is not None:
        dt = DataType(dtype)
        if dt.is_complex and dt.is_integer and t.is_complex():
            t = storage_view(t, dt)
        elif t.dtype != dt.as_torch_dtype():
            t = t.to(dt.as_torch_dtype())
    if space == "cuda":
        return asarray(t, space, device)
    return t.to(space_device(space, torch.device("cpu")))
