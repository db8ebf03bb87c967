"""Arrays by memory space (counterpart of bifrost_tpu/ndarray.py).

Host arrays are the JAX package's: `ndarray`, a numpy subclass carrying
a `.bf` `BFArrayInfo` (space, DataType, conjugated), over numpy memory or
over a host address (`buffer=`, e.g. a `memory.raw_malloc` block).
Device arrays are ``torch.Tensor``s, where the JAX package has
``jax.Array``s: a CUDA tensor is in 'cuda', a pinned CPU tensor in
'cuda_host', any other CPU tensor in 'system' (`get_space`).  Storage
conventions are the JAX package's: complex integers carry a trailing
(re, im) axis of 2 in a tensor and are the structured (re, im) dtype in
a host array; packed sub-byte types fold their last axis into uint8
bytes.

`asarray`, `empty`, `zeros`, `empty_like`, `zeros_like`, `copy_array` and
`memset_array` follow the JAX semantics across the spaces; 'cuda' is the
thread's device (`device.get_device`, the card unless the caller bound
the CPU), and 'cuda_host' is pinned memory or an error, never pageable
memory in its place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .DataType import DataType
from .memory import Space, require_pinning, space_device


class BFArrayInfo(object):
    """A host array's metadata (bifrost_tpu/ndarray.py:26-43): its space,
    DataType, byte order, conjugation, and whether it owns its buffer
    (False for views of memory recycled by someone else, a ring span)."""

    def __init__(self, space, dtype, native=True, conjugated=False,
                 ownbuffer=True):
        self.space = str(Space(space))
        self.dtype = DataType(dtype)
        self.native = native
        self.conjugated = conjugated
        self.ownbuffer = ownbuffer

    def __repr__(self):
        return (f"BFArrayInfo(space='{self.space}', dtype='{self.dtype}', "
                f"native={self.native}, conjugated={self.conjugated})")


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


class ndarray(np.ndarray):
    """Host-space array: numpy + `.bf` metadata (the JAX package's class,
    bifrost_tpu/ndarray.py:68-156, without its JAX transfer).

    `ndarray(base=a)` views `a`; `ndarray(buffer=address, shape=,
    dtype=)` views host memory at an integer address (a `raw_malloc`
    block, a ring span); `ndarray(shape=, dtype=)` allocates."""

    def __new__(cls, base=None, space=None, shape=None, dtype=None,
                buffer=None, offset=0, strides=None, native=True,
                conjugated=False):
        if dtype is not None:
            bf_dtype = DataType(dtype)
            np_dtype = bf_dtype.as_numpy_dtype()
        else:
            bf_dtype = None
            np_dtype = None

        if base is not None:
            if isinstance(base, ndarray) and dtype is None:
                bf_dtype = base.bf.dtype
                np_dtype = bf_dtype.as_numpy_dtype()
            arr = np.asarray(base, dtype=np_dtype)
            if shape is not None:
                arr = arr.reshape(_storage_shape(shape, bf_dtype or arr.dtype))
            obj = arr.view(cls)
        elif buffer is not None:
            if shape is None or bf_dtype is None:
                raise ValueError("shape and dtype required with buffer=")
            sshape = _storage_shape(shape, bf_dtype)
            itemsize = np_dtype.itemsize
            if strides is None:
                strides = [itemsize]
                for s in reversed(sshape[1:]):
                    strides.insert(0, strides[0] * s)
                strides = tuple(strides) if sshape else ()
            if any(s == 0 for s in sshape):
                extent = itemsize
            else:
                extent = sum((s - 1) * st for s, st in zip(sshape, strides)) \
                    + itemsize
            extent += (-extent) % itemsize  # pad to element granularity
            ctbuf = (ctypes.c_char * extent).from_address(buffer + offset)
            raw = np.frombuffer(ctbuf, dtype=np.uint8).view(np_dtype)
            arr = np.lib.stride_tricks.as_strided(raw, shape=sshape,
                                                  strides=strides)
            obj = arr.view(cls)
        else:
            if shape is None:
                raise ValueError("shape required")
            if bf_dtype is None:
                bf_dtype = DataType("f32")
                np_dtype = bf_dtype.as_numpy_dtype()
            obj = np.empty(_storage_shape(shape, bf_dtype),
                           dtype=np_dtype).view(cls)

        if bf_dtype is None:
            bf_dtype = DataType(obj.dtype)
        obj.bf = BFArrayInfo(space or "system", bf_dtype, native, conjugated)
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.bf = getattr(obj, "bf", None) or BFArrayInfo(
            "system", DataType(self.dtype) if self.dtype.names is None
            and self.dtype.kind in "iufc" else "u8")

    @property
    def logical_shape(self):
        return logical_shape(self.shape, self.bf.dtype) \
            if self.bf.dtype.itemsize_bits < 8 else tuple(self.shape)

    def as_cpu(self):
        return self

    def conj(self):
        out = super().conj().view(ndarray)
        out.bf = BFArrayInfo(self.bf.space, self.bf.dtype, self.bf.native,
                             not self.bf.conjugated)
        return out


# torch storage dtype -> the DataType of a host array of it
_TORCH_BF = {torch.int8: "i8", torch.uint8: "u8", torch.int16: "i16",
             torch.int32: "i32", torch.int64: "i64", torch.float16: "f16",
             torch.bfloat16: "bf16", torch.float32: "f32",
             torch.float64: "f64", torch.complex64: "cf32",
             torch.complex128: "cf64"}


def _host_tensor(a):
    """A CPU tensor over host array `a`'s own memory, in storage form
    (structured complex integers as their (re, im) pair axis; bfloat16
    through its bits)."""
    a = np.asarray(a).view(np.ndarray)
    if a.dtype.names is not None:
        a = a.view(a.dtype[a.dtype.names[0]]).reshape(a.shape + (2,))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def get_space(arr):
    """The space `arr` lives in: a host `ndarray`'s `.bf` space; 'system'
    for numpy; 'cuda' for a CUDA tensor, 'cuda_host' for a pinned one,
    'system' for any other CPU tensor."""
    if isinstance(arr, ndarray):
        return arr.bf.space
    if isinstance(arr, torch.Tensor):
        if arr.is_cuda:
            return "cuda"
        return "cuda_host" if arr.is_pinned() else "system"
    return "system"


def _pinned(t):
    """`t` (a CPU tensor) in pinned memory, or BifrostError."""
    if t.is_pinned():
        return t
    require_pinning()
    return t.pin_memory()


def asarray(x, space=None, dtype=None, device=None):
    """`x` (numpy, a host `ndarray` or a tensor) in `space`, the JAX
    semantics: with no `space`, `x` keeps its own; 'system' gives a host
    `ndarray`; 'cuda' a tensor on `device` (default: this thread's, the
    card unless the caller bound the CPU); 'cuda_host' a pinned tensor.
    `dtype` (a DataType name) converts the values."""
    target = Space(space).space if space is not None else get_space(x)
    if target == "system":
        if isinstance(x, torch.Tensor):
            if dtype is not None:
                x = x.to(DataType(dtype).as_torch_dtype())
            a = x.detach().cpu()
            dt = DataType(dtype) if dtype is not None else None
            if dt is not None and dt.is_complex and dt.is_integer:
                return ndarray(base=pair_to_structured(a.numpy(), dt),
                               dtype=dt)
            a = a.view(torch.int16).numpy().view(
                DataType("bf16").as_numpy_dtype()) \
                if a.dtype == torch.bfloat16 else a.numpy()
            return ndarray(base=a, space="system", dtype=dtype)
        if isinstance(x, ndarray) and dtype is None:
            return x
        return ndarray(base=np.asarray(x), space="system", dtype=dtype)
    if isinstance(x, torch.Tensor):
        t = x if dtype is None else x.to(DataType(dtype).as_torch_dtype())
    else:
        a = np.asarray(x) if dtype is None else \
            np.asarray(x, dtype=DataType(dtype).as_numpy_dtype())
        if a.dtype.names is not None:      # structured complex-int -> (re, im)
            a = structured_to_pair(a)
        t = _host_tensor(np.ascontiguousarray(a))
    if target == "cuda_host":
        return _pinned(t.cpu())
    from .device import get_device
    device = get_device() if device is None else torch.device(device)
    return t.to(space_device(target, device))


def _empty_tensor(shape, torch_dtype, space, device=None):
    if space == "cuda_host":
        require_pinning()
        return torch.empty(shape, dtype=torch_dtype, pin_memory=True)
    from .device import get_device
    device = get_device() if device is None else torch.device(device)
    return torch.empty(shape, dtype=torch_dtype, device=device)


def empty(shape, dtype="f32", space="system", device=None):
    """An uninitialized array of logical `shape` and `dtype` in `space`:
    a host `ndarray` in 'system', a tensor in storage form in 'cuda'
    (on `device`, default this thread's) and 'cuda_host' (pinned)."""
    space = Space(space).space
    if space == "system":
        return ndarray(shape=shape, dtype=dtype, space=space)
    dt = DataType(dtype)
    return _empty_tensor(tensor_shape(shape, dt), dt.as_torch_dtype(),
                         space, device)


def zeros(shape, dtype="f32", space="system", device=None):
    out = empty(shape, dtype, space, device)
    return memset_array(out, 0)


def empty_like(other, space=None):
    """An uninitialized array like `other` (its shape and type; a tensor's
    storage shape and type, so complex-integer pairs and packed bytes
    stay as they are) in `space`, default `other`'s own; a CUDA tensor's
    copy stays on its card."""
    space = Space(space).space if space is not None else get_space(other)
    if isinstance(other, torch.Tensor):
        shape = tuple(other.shape)
        if space == "system":
            return empty(shape, _TORCH_BF[other.dtype], space)
        device = other.device if other.is_cuda else None
        return _empty_tensor(shape, other.dtype, space, device)
    if isinstance(other, ndarray):
        return empty(other.logical_shape, other.bf.dtype, space)
    a = np.asarray(other)
    return empty(a.shape, DataType(a.dtype), space)


def zeros_like(other, space=None):
    return memset_array(empty_like(other, space), 0)


def copy_array(dst, src):
    """Copy `src` into `dst` across spaces, in every direction between
    host arrays (numpy, `ndarray`) and tensors; shapes match in storage
    form.  A tensor lands in host memory with one copy into `dst`'s own
    bytes."""
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor):
            src = _host_tensor(np.ascontiguousarray(src))
        dst.copy_(src)
        return dst
    if isinstance(src, torch.Tensor):
        _host_tensor(dst).copy_(src)
        return dst
    d, s = np.asarray(dst), np.asarray(src)
    np.copyto(d.view(s.dtype) if d.dtype != s.dtype else d, s)
    return dst


def memset_array(arr, value=0):
    """Set every byte of `arr` (a host array or a tensor) to `value`."""
    if isinstance(arr, torch.Tensor):
        if not arr.is_contiguous():
            raise ValueError(f"memset_array of a non-contiguous tensor "
                             f"(strides {arr.stride()})")
        arr.view(-1).view(torch.uint8).fill_(value)
        return arr
    np.asarray(arr).view(np.uint8)[...] = value
    return arr

