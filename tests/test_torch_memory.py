"""The port's L0 memory surface (bifrost_tpu_torch/memory.py) against the
JAX package's (bifrost_tpu/memory.py over its C core): the cases of
tests/test_memory.py with the port's space names ('cuda', 'cuda_host';
the JAX spellings stay aliases), the 'cuda' refusal, and host copies
compared byte for byte with the C core's."""

import ctypes

import numpy as np
import pytest
import torch

import bifrost_tpu as jbf
from bifrost_tpu import memory as jmem

import bifrost_tpu_torch as bf
from bifrost_tpu_torch import memory

# The JAX spelling of each port space.
JAX_NAME = {"system": "system", "cuda": "tpu", "cuda_host": "tpu_host"}


def test_space_names():
    assert str(bf.Space("system")) == "system"
    assert str(bf.Space("cuda")) == "cuda"
    assert str(bf.Space("tpu")) == "cuda"          # the JAX spelling
    assert str(bf.Space("tpu_host")) == "cuda_host"
    with pytest.raises(ValueError):
        bf.Space("nonsense")
    for space, jname in JAX_NAME.items():
        assert bf.Space(space).as_BFspace() == \
            jbf.Space(jname).as_BFspace()


def test_space_accessible():
    assert bf.space_accessible("system", ["system"])
    assert bf.space_accessible("cuda_host", ["system"])
    assert not bf.space_accessible("cuda", ["system"])
    assert bf.space_accessible("cuda", "any")
    for space in JAX_NAME:
        for frm in JAX_NAME:
            assert bf.space_accessible(space, [frm]) == \
                jbf.space_accessible(JAX_NAME[space], [JAX_NAME[frm]]), \
                (space, frm)
    assert bf.space_accessible("tpu_host", "system")


def test_raw_alloc_and_space():
    ptr = memory.raw_malloc(1024, "system")
    assert ptr % memory.alignment() == 0
    assert memory.alignment() == jmem.alignment()
    assert memory.raw_get_space(ptr) == "system"
    memory.raw_free(ptr)
    with pytest.raises(bf.BifrostError):
        memory.raw_free(ptr)            # freed already
    if torch.cuda.is_available():
        ptr = memory.raw_malloc(1024, "cuda_host")
        assert ptr % memory.alignment() == 0
        assert memory.raw_get_space(ptr) == "cuda_host"
        assert memory.raw_pinned(ptr)
        memory.raw_free(ptr, "cuda_host")
    else:
        # No CUDA runtime to pin with: an error, never pageable memory.
        with pytest.raises(bf.BifrostError, match="pinned"):
            memory.raw_malloc(1024, "cuda_host")


def test_cuda_space_not_host_allocatable():
    for space in ("cuda", "tpu"):
        with pytest.raises(bf.BifrostError) as err:
            memory.raw_malloc(64, space)
        assert err.value.status == 25           # unsupported space
    with pytest.raises(jbf.BifrostError) as jerr:
        jmem.raw_malloc(64, "tpu")
    assert jerr.value.status == err.value.status


def test_memcpy2d():
    src = np.arange(48, dtype=np.uint8).reshape(6, 8).copy()
    dst = np.zeros((6, 16), dtype=np.uint8)
    memory.memcpy2D(dst.ctypes.data, 16, src.ctypes.data, 8, 8, 6)
    np.testing.assert_array_equal(dst[:, :8], src)
    assert (dst[:, 8:] == 0).all()
    jdst = np.zeros((6, 16), dtype=np.uint8)
    jmem.memcpy2D(jdst.ctypes.data, 16, src.ctypes.data, 8, 8, 6)
    assert dst.tobytes() == jdst.tobytes()


def test_memset():
    buf = np.zeros(64, dtype=np.uint8)
    memory.memset(buf.ctypes.data, 0xAB, 32)
    assert (buf[:32] == 0xAB).all() and (buf[32:] == 0).all()
    jbuf = np.zeros(64, dtype=np.uint8)
    jmem.memset(jbuf.ctypes.data, 0xAB, 32)
    assert buf.tobytes() == jbuf.tobytes()


def test_memcpy_and_an_ndarray_over_a_raw_block():
    """A host `ndarray` over a raw_malloc block (`buffer=`) reads and
    writes the block's own bytes, as the JAX array over its C core's."""
    n = 24
    ptr = memory.raw_malloc(n * 4, "system")
    try:
        src = np.arange(n, dtype=np.float32)
        memory.memcpy(ptr, src.ctypes.data, src.nbytes)
        a = bf.ndarray(buffer=ptr, shape=(4, 6), dtype="f32")
        np.testing.assert_array_equal(a, src.reshape(4, 6))
        assert a.bf.space == "system" and str(a.bf.dtype) == "f32"
        a[1] = -1.0
        back = (ctypes.c_float * n).from_address(ptr)
        assert list(back)[6:12] == [-1.0] * 6
    finally:
        memory.raw_free(ptr)
