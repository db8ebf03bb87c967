"""Tensors by memory space (counterpart of bifrost_tpu/ndarray.py).

The JAX package wraps host memory in an ``np.ndarray`` subclass and moves
device data as ``jax.Array``s.  Here every array is a ``torch.Tensor``;
its space follows from its device ('cuda' for a CUDA tensor, 'system'
otherwise, 'cuda_host' when pinned) or, for a tensor on a CPU-bound
pipeline, from the ring that holds it.  Storage conventions are the JAX
package's: complex integers carry a trailing (re, im) axis of 2, packed
sub-byte types fold their last axis into uint8 bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .DataType import DataType
from .memory import Space, space_device


def _storage_shape(shape, dtype):
    """Logical shape -> storage shape for packed types (fold last axis)."""
    dtype = DataType(dtype)
    if dtype.itemsize_bits >= 8:        # ci4 packs one sample a byte
        return tuple(shape)
    vals_per_byte = 8 // dtype.itemsize_bits
    shape = tuple(shape)
    if not shape:
        raise ValueError("packed scalar has no axis to fold")
    if shape[-1] % vals_per_byte:
        raise ValueError(
            f"last axis ({shape[-1]}) must be divisible by {vals_per_byte} "
            f"for packed dtype {dtype}")
    return shape[:-1] + (shape[-1] // vals_per_byte,)


def tensor_shape(shape, dtype):
    """Storage tensor shape of a logical `shape` of `dtype`: packed types
    fold the last axis, complex integers gain the (re, im) axis."""
    dt = DataType(dtype)
    shape = _storage_shape(shape, dt)
    if dt.nbit >= 8 and dt.is_complex and dt.is_integer:
        shape = tuple(shape) + (2,)
    return tuple(shape)


def structured_to_pair(a):
    """Structured complex-int numpy array (fields re, im) -> its component
    integer array with a trailing (re, im) axis of 2, the storage form."""
    a = np.ascontiguousarray(a)
    return a.view(a.dtype[a.dtype.names[0]]).reshape(a.shape + (2,))


def pair_to_structured(a, dtype="ci8"):
    """Storage form (trailing (re, im) axis of 2) -> the structured numpy
    array of complex-integer `dtype` (the JAX package's host form)."""
    a = np.ascontiguousarray(a)
    if a.shape[-1] != 2:
        raise ValueError(f"expected a trailing (re, im) axis of 2, got "
                         f"shape {a.shape}")
    want = DataType(dtype).as_numpy_dtype()
    return a.astype(want[want.names[0]]).view(want).reshape(a.shape[:-1])


def logical_shape(storage_shape, dtype):
    """Storage tensor shape -> logical shape (the inverse of
    `tensor_shape` for complex integers of 8 bits or more)."""
    dt = DataType(dtype)
    shape = tuple(storage_shape)
    if dt.nbit >= 8 and dt.is_complex and dt.is_integer:
        if not shape or shape[-1] != 2:
            raise ValueError(f"{dt} storage needs a trailing (re, im) axis "
                             f"of 2, got shape {shape}")
        return shape[:-1]
    if dt.itemsize_bits < 8:
        return shape[:-1] + (shape[-1] * (8 // dt.itemsize_bits),)
    return shape


def complex_view(t, dtype):
    """The logical complex64 value of a complex-integer storage tensor
    (ci8/ci16/ci32: trailing (re, im) axis of 2; ci4: packed bytes, one
    sample a byte), lifted exactly; a complex tensor passes through."""
    dt = DataType(dtype)
    if t.is_complex():
        return t
    if not (dt.is_complex and dt.is_integer):
        raise ValueError(f"complex_view expects a complex-integer type, "
                         f"got {dt}")
    if dt.nbit < 8:
        from .ops.unpack import unpack_pairs
        t = unpack_pairs(t, dt)
    return torch.complex(t[..., 0].float(), t[..., 1].float())


def storage_view(z, dtype):
    """A logical complex tensor -> complex-integer storage (trailing (re,
    im) axis of 2) of `dtype`, rounded to the nearest integer."""
    dt = DataType(dtype)
    if not (dt.is_complex and dt.is_integer and dt.nbit >= 8):
        raise ValueError(f"storage_view expects ci8 or wider, got {dt}")
    return torch.stack([z.real.round(), z.imag.round()], dim=-1) \
        .to(dt.as_torch_dtype())


def asarray(x, space="cuda", device=None):
    """`x` (numpy or tensor) as a tensor in `space`; `device` backs the
    'cuda' space (default: this thread's device, the card unless the
    caller bound the CPU)."""
    from .device import get_device
    device = get_device() if device is None else torch.device(device)
    dev = space_device(space, device)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    a = np.asarray(x)
    if a.dtype.names is not None:      # structured complex-int -> (re, im)
        a = structured_to_pair(a)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def empty(shape, dtype="f32", space="cuda", device=None):
    from .device import get_device
    device = get_device() if device is None else torch.device(device)
    dt = DataType(dtype)
    pin = Space(space).space == "cuda_host" and device.type == "cuda"
    return torch.empty(tensor_shape(shape, dt), dtype=dt.as_torch_dtype(),
                       device=space_device(space, device), pin_memory=pin)


def zeros(shape, dtype="f32", space="cuda", device=None):
    out = empty(shape, dtype, space, device)
    out.zero_()
    return out


def copy_array(dst, src):
    """Copy `src` into `dst` across spaces (shapes must match)."""
    if not isinstance(src, torch.Tensor):
        src = torch.from_numpy(np.ascontiguousarray(src))
    dst.copy_(src)
    return dst
