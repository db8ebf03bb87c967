"""The port's functional ops with host out-arrays, against the JAX ops
on the same numpy input (the out-parameter cases of tests/test_ops.py):
transpose, the four reduce ops, scrunch, power and ci8 input, the
`Fft.init` plans, the prepare of packed ci4, fftshift and the FDMT into
a host `ndarray`, and the one-shot FFT.  Bitwise where the arithmetic is
exact (integer-valued inputs make every sum exact); the FFTs within the
bound of tests/test_torch_gpuspec.py, 32 eps_f32 sqrt(n) max|want|.

Also the array surface of the port's ndarray module against the JAX
package's (asarray, empty_like, zeros_like, copy_array, memset_array,
get_space), and the guard on `prepare`: numpy input to every op that
lifts it goes to the thread's device, the card unless the caller bound
the CPU, and never falls back to the CPU by itself."""

import threading

import numpy as np
import pytest
import torch

import bifrost_tpu as jbf
from bifrost_tpu import ndarray as jndarray

import bifrost_tpu_torch as bf
from bifrost_tpu_torch import device
from bifrost_tpu_torch import ndarray


@pytest.fixture
def on_cpu():
    """Bind this thread to the CPU (numpy operands of an op go to the
    thread's device, the card by default)."""
    device.set_device("cpu")
    yield
    device._tls.device = None


def _ints(rng, shape, hi=16):
    return rng.integers(0, hi, shape).astype(np.float32)


def _fft_bound(n, want):
    return 32 * np.finfo(np.float32).eps * np.sqrt(n) * \
        np.abs(want).max()


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


# ------------------------------------------------------------- transpose
def test_transpose(on_cpu):
    from bifrost_tpu.ops import transpose as jtranspose
    from bifrost_tpu_torch.ops import transpose
    a = np.random.default_rng(0).random((3, 4, 5)).astype(np.float32)
    out = np.empty((5, 3, 4), dtype=np.float32).view(ndarray)
    jout = np.empty((5, 3, 4), dtype=np.float32).view(jndarray)
    assert transpose(out, a, axes=(2, 0, 1)) is out
    jtranspose(jout, a, axes=(2, 0, 1))
    assert _bits(out) == _bits(jout)
    np.testing.assert_array_equal(out, a.transpose(2, 0, 1))


def test_transpose_ci8_into_a_host_ci8_array(on_cpu):
    """A ci8 host array in, a ci8 host array out: lifted to complex and
    lowered to (re, im) storage again, as the JAX op does."""
    from bifrost_tpu.ops import transpose as jtranspose
    from bifrost_tpu_torch.ops import transpose
    raw = np.zeros((2, 3), dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = np.arange(6).reshape(2, 3) - 3
    raw["im"] = 2
    a = ndarray(base=raw, dtype="ci8")
    out = bf.empty((3, 2), dtype="ci8")
    jout = jbf.empty((3, 2), dtype="ci8")
    transpose(out, a, axes=(1, 0))
    jtranspose(jout, jndarray(base=raw, dtype="ci8"), axes=(1, 0))
    assert _bits(out) == _bits(jout)


# ---------------------------------------------------------------- reduce
@pytest.mark.parametrize("op", ["sum", "mean", "min", "max"])
def test_reduce_full_axis(on_cpu, op):
    from bifrost_tpu.ops import reduce as jreduce
    from bifrost_tpu_torch.ops import reduce
    a = _ints(np.random.default_rng(1), (4, 8, 6))
    out = np.empty((4, 1, 6), dtype=np.float32).view(ndarray)
    jout = np.empty((4, 1, 6), dtype=np.float32).view(jndarray)
    reduce(a, out, op)
    jreduce(a, jout, op)
    assert _bits(out) == _bits(jout)
    np.testing.assert_array_equal(out, getattr(np, op)(a, axis=1,
                                                       keepdims=True))


def test_reduce_scrunch(on_cpu):
    from bifrost_tpu.ops import reduce as jreduce
    from bifrost_tpu_torch.ops import reduce
    a = _ints(np.random.default_rng(2), (4, 8))
    out = np.empty((4, 2), dtype=np.float32).view(ndarray)
    jout = np.empty((4, 2), dtype=np.float32).view(jndarray)
    reduce(a, out, "sum")
    jreduce(a, jout, "sum")
    assert _bits(out) == _bits(jout)
    np.testing.assert_array_equal(out, a.reshape(4, 2, 4).sum(axis=2))


def test_reduce_power(on_cpu):
    from bifrost_tpu.ops import reduce as jreduce
    from bifrost_tpu_torch.ops import reduce
    rng = np.random.default_rng(3)
    a = (_ints(rng, (4, 8)) + 1j * _ints(rng, (4, 8))).astype(np.complex64)
    out = np.empty((4, 1), dtype=np.float32).view(ndarray)
    jout = np.empty((4, 1), dtype=np.float32).view(jndarray)
    reduce(a, out, "pwrsum")
    jreduce(a, jout, "pwrsum")
    assert _bits(out) == _bits(jout)
    np.testing.assert_array_equal(
        out, (a.real ** 2 + a.imag ** 2).sum(axis=1, keepdims=True))


def test_reduce_ci8_input(on_cpu):
    from bifrost_tpu.ops import reduce as jreduce
    from bifrost_tpu_torch.ops import reduce
    raw = np.zeros((2, 4), dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = np.arange(8).reshape(2, 4)
    raw["im"] = 1
    out = np.empty((2, 1), dtype=np.float32).view(ndarray)
    jout = np.empty((2, 1), dtype=np.float32).view(jndarray)
    reduce(ndarray(base=raw, dtype="ci8"), out, "pwrsum")
    jreduce(jndarray(base=raw, dtype="ci8"), jout, "pwrsum")
    assert _bits(out) == _bits(jout)
    golden = (raw["re"].astype(np.float32) ** 2 +
              raw["im"].astype(np.float32) ** 2).sum(axis=1, keepdims=True)
    np.testing.assert_array_equal(out, golden)


# ------------------------------------------------------------------- fft
def _fft_pair(a, oshape, odtype, axes, shift=False, inverse=False,
              ibf=None):
    """One Fft.init/execute plan on each package, into host arrays."""
    from bifrost_tpu.ops import Fft as JFft
    from bifrost_tpu_torch.ops import Fft
    out = np.empty(oshape, dtype=odtype).view(ndarray)
    jout = np.empty(oshape, dtype=odtype).view(jndarray)
    pin = ndarray(base=a, dtype=ibf) if ibf else a
    jin = jndarray(base=a, dtype=ibf) if ibf else a
    plan, jplan = Fft(), JFft()
    assert plan.init(pin, out, axes=axes, apply_fftshift=shift) == 0
    jplan.init(jin, jout, axes=axes, apply_fftshift=shift)
    assert plan.kind == jplan.kind
    plan.execute(pin, out, inverse=inverse)
    jplan.execute(jin, jout, inverse=inverse)
    return np.asarray(out), np.asarray(jout)


def _check_fft(out, jout, want, n):
    bound = _fft_bound(n, want)
    assert np.abs(out - want).max() <= bound
    assert np.abs(out - jout).max() <= bound


def test_fft_c2c(on_cpu):
    rng = np.random.default_rng(4)
    a = (rng.random((4, 64)) + 1j * rng.random((4, 64))).astype(np.complex64)
    out, jout = _fft_pair(a, a.shape, np.complex64, 1)
    _check_fft(out, jout, np.fft.fft(a, axis=1), 64)


def test_fft_inverse_unnormalized(on_cpu):
    rng = np.random.default_rng(5)
    a = (rng.random(32) + 1j * rng.random(32)).astype(np.complex64)
    out, jout = _fft_pair(a, a.shape, np.complex64, 0, inverse=True)
    _check_fft(out, jout, np.fft.ifft(a) * 32, 32)


def test_fft_r2c(on_cpu):
    a = np.random.default_rng(6).random((8, 64)).astype(np.float32)
    out, jout = _fft_pair(a, (8, 33), np.complex64, 1)
    _check_fft(out, jout, np.fft.rfft(a, axis=1), 64)


def test_fft_c2r(on_cpu):
    t = np.random.default_rng(7).random(16).astype(np.float32)
    f = np.fft.rfft(t).astype(np.complex64)
    out, jout = _fft_pair(f, (16,), np.float32, 0, ibf="cf32")
    _check_fft(out, jout, t * 16, 16)


def test_fft_shift(on_cpu):
    rng = np.random.default_rng(8)
    a = (rng.random(64) + 1j * rng.random(64)).astype(np.complex64)
    out, jout = _fft_pair(a, a.shape, np.complex64, 0, shift=True)
    _check_fft(out, jout, np.fft.fftshift(np.fft.fft(a)), 64)


def test_fft_ci8_input(on_cpu):
    rng = np.random.default_rng(9)
    raw = np.zeros(32, dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = rng.integers(-8, 8, 32)
    raw["im"] = rng.integers(-8, 8, 32)
    out, jout = _fft_pair(raw, (32,), np.complex64, 0, ibf="ci8")
    golden = np.fft.fft(raw["re"].astype(np.float32) +
                        1j * raw["im"].astype(np.float32))
    _check_fft(out, jout, golden, 32)


def test_fft_c2r_shift(on_cpu):
    """c2r with apply_fftshift: the input-side ifftshift of the full
    spectrum as a (-1)^m modulation; odd lengths refused at init."""
    from bifrost_tpu_torch.ops import Fft
    t = np.random.default_rng(10).standard_normal(32).astype(np.float32)
    f = np.fft.rfft(t).astype(np.complex64)
    out, jout = _fft_pair(f, (32,), np.float32, 0, shift=True, ibf="cf32")
    full = np.fft.fft(t).astype(np.complex64)
    golden = np.fft.ifft(np.fft.ifftshift(full)).real * 32
    _check_fft(out, jout, golden, 32)
    f_odd = np.fft.rfft(np.ones(31)).astype(np.complex64)
    out_odd = np.empty(31, dtype=np.float32).view(ndarray)
    with pytest.raises(NotImplementedError):
        Fft().init(ndarray(base=f_odd, dtype="cf32"), out_odd, axes=0,
                   apply_fftshift=True)


def test_one_shot_fft_and_execute_workspace(on_cpu):
    from bifrost_tpu.ops.fft import fft as jfft
    from bifrost_tpu_torch.ops import Fft
    rng = np.random.default_rng(11)
    a = (rng.random((4, 16)) + 1j * rng.random((4, 16))).astype(
        np.complex64)
    want = np.fft.fft(a, axis=1)
    res = bf.fft.fft(a, axes=1)
    assert isinstance(res, torch.Tensor) and res.device.type == "cpu"
    _check_fft(res.numpy(), np.asarray(jfft(a, axes=1)), want, 16)
    out = bf.empty((4, 16), dtype="cf32")
    assert bf.fft.fft(a, out, axes=1) is out
    plan = Fft()
    out2 = bf.zeros((4, 16), dtype="cf32")
    plan.init(a, out2, axes=1)
    plan.execute_workspace(a, out2)
    assert _bits(out) == _bits(out2)
    _check_fft(np.asarray(out), res.numpy(), want, 16)


def test_prepare_unpacks_ci4_to_logical_complex(on_cpu):
    from bifrost_tpu.ops import quantize as jquantize
    from bifrost_tpu.ops.common import prepare as jprepare
    from bifrost_tpu_torch.ops import quantize
    from bifrost_tpu_torch.ops.common import prepare
    re = np.array([1, -3, 5, -7], np.float32)
    im = np.array([2, -4, -6, 7], np.float32)
    a = (re + 1j * im).astype(np.complex64)
    q = bf.empty((4,), dtype="ci4")
    jq = jbf.empty((4,), dtype="ci4")
    quantize(a, q, scale=1.0)
    jquantize(a, jq, scale=1.0)
    assert _bits(q) == _bits(jq)
    t = prepare(q)
    j, _, _ = jprepare(jq)
    assert tuple(t.shape) == (4,)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_array_equal(t.numpy(), a)


def test_fftshift_op(on_cpu):
    from bifrost_tpu.ops import fftshift as jfftshift
    from bifrost_tpu_torch.ops import fftshift
    a = np.arange(8, dtype=np.float32)
    out = np.empty(8, dtype=np.float32).view(ndarray)
    jout = np.empty(8, dtype=np.float32).view(jndarray)
    fftshift(a, axes=0, dst=out)
    jfftshift(a, axes=0, dst=jout)
    assert _bits(out) == _bits(jout)


def test_fdmt_into_a_host_ndarray(on_cpu):
    """Fdmt.execute(x, out) with a host out-array: integer-valued input
    keeps every add exact, so the port is bitwise the JAX op."""
    from bifrost_tpu.ops import Fdmt as JFdmt
    from bifrost_tpu_torch.ops import Fdmt
    nchan, ntime, max_delay = 16, 128, 32
    x = _ints(np.random.default_rng(12), (nchan, ntime))
    plan = Fdmt().init(nchan, max_delay, f0=60e6, df=0.1e6)
    jplan = JFdmt()
    jplan.init(nchan, max_delay, f0=60e6, df=0.1e6)
    assert plan.get_workspace_size() == jplan.get_workspace_size() == 0
    out = np.empty((max_delay, ntime), dtype=np.float32).view(ndarray)
    jout = np.empty((max_delay, ntime), dtype=np.float32).view(jndarray)
    assert plan.execute(x, out) is out
    jplan.execute(x, jout)
    assert _bits(out) == _bits(jout)
    np.testing.assert_array_equal(out[0], x.sum(axis=0))


# ------------------------------------------------------ the array surface
def test_asarray_follows_the_jax_semantics(on_cpu):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    h = bf.asarray(a)                       # keeps its space: system
    j = jbf.asarray(a)
    assert type(h) is ndarray and h.bf.space == j.bf.space == "system"
    assert bf.asarray(h) is h
    t = bf.asarray(a, space="cuda")         # the thread's device
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert bf.get_space(t) == "system"      # a CPU tensor's space
    back = bf.asarray(t, space="system")
    assert type(back) is ndarray and _bits(back) == _bits(j)
    raw = np.zeros(3, dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = [1, -2, 3]
    tc = bf.asarray(ndarray(base=raw, dtype="ci8"), space="cuda")
    assert tuple(tc.shape) == (3, 2) and tc.dtype == torch.int8
    hc = bf.asarray(tc, space="system", dtype="ci8")
    assert str(hc.bf.dtype) == "ci8" and hc.tobytes() == raw.tobytes()
    assert bf.asarray(a, dtype="f64").dtype == np.float64


def test_empty_like_and_zeros_like_keep_space_and_type(on_cpu):
    for dtype in ("f32", "ci8", "i4", "ci4", "cf32"):
        a = bf.zeros((4, 8), dtype=dtype)
        ja = jbf.zeros((4, 8), dtype=dtype)
        assert _bits(a) == _bits(ja), dtype
        for like in (bf.empty_like, bf.zeros_like):
            b = like(a)
            assert type(b) is ndarray and b.bf.space == "system"
            assert b.bf.dtype == a.bf.dtype and b.shape == a.shape
            assert b.logical_shape == a.logical_shape
        t = bf.zeros_like(a, space="cuda")
        assert isinstance(t, torch.Tensor)
        assert tuple(t.shape) == ndarray_tensor_shape(a)
        assert not t.any()
        tt = bf.empty_like(t, space="cuda")
        assert tt.shape == t.shape and tt.dtype == t.dtype
        # On a CPU-bound thread the tensor is in 'system': its like is a
        # host array of its storage shape.
        assert type(bf.empty_like(t)) is ndarray
        assert bf.empty_like(t).shape == tuple(t.shape)
    n = np.ones(5, np.float64)
    assert _bits(bf.zeros_like(n)) == _bits(jbf.zeros_like(n))


def ndarray_tensor_shape(a):
    from bifrost_tpu_torch.ndarray import tensor_shape
    return tensor_shape(a.logical_shape, a.bf.dtype)


def test_copy_array_in_every_direction(on_cpu):
    rng = np.random.default_rng(13)
    src = rng.integers(-100, 100, (3, 4)).astype(np.int16)
    host = bf.empty((3, 4), dtype="i16")
    assert bf.copy_array(host, src) is host       # numpy -> ndarray
    t = torch.zeros(3, 4, dtype=torch.int16)
    bf.copy_array(t, host)                         # ndarray -> tensor
    back = np.zeros((3, 4), np.int16)
    bf.copy_array(back, t)                         # tensor -> numpy
    t2 = torch.empty_like(t)
    bf.copy_array(t2, t)                           # tensor -> tensor
    j = jbf.empty((3, 4), dtype="i16")
    jbf.copy_array(j, src)
    for got in (host, back, t.numpy(), t2.numpy()):
        assert _bits(got) == _bits(j)
    raw = np.zeros(4, dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = [1, 2, 3, 4]
    raw["im"] = -1
    dst = bf.empty((4,), dtype="ci8")
    bf.copy_array(dst, torch.from_numpy(raw.view(np.int8).reshape(4, 2)))
    assert dst.tobytes() == raw.tobytes()


def test_memset_array_on_host_arrays_and_tensors():
    a = bf.zeros((8,), dtype="u8")
    ja = jbf.zeros((8,), dtype="u8")
    bf.memset_array(a, 7)
    jbf.memset_array(ja, 7)
    assert _bits(a) == _bits(ja)
    t = torch.ones(2, 3, dtype=torch.float32)
    assert bf.memset_array(t) is t and not t.any()
    bf.memset_array(t, 0xFF)
    assert (t.view(torch.int32) == -1).all()
    with pytest.raises(ValueError, match="non-contiguous"):
        bf.memset_array(torch.zeros(4, 4).t(), 1)


def test_get_space_of_each_array():
    assert bf.get_space(np.zeros(2)) == "system"
    assert bf.get_space(bf.empty((2,))) == "system"
    h = ndarray(base=np.zeros(2), space="cuda_host")
    assert bf.get_space(h) == "cuda_host"
    assert bf.get_space(torch.zeros(2)) == "system"
    assert bf.get_space(h.conj()) == "cuda_host"
    assert h.conj().bf.conjugated and not h.bf.conjugated


def test_cuda_host_arrays_are_pinned_or_refused():
    """'cuda_host' is pinned memory: with no CUDA runtime to pin with,
    the surface raises rather than hand out pageable memory."""
    if torch.cuda.is_available():
        pytest.skip("covered on the card by tests/test_torch_gpu.py")
    for make in (lambda: bf.empty((4,), space="cuda_host"),
                 lambda: bf.asarray(np.zeros(4), space="cuda_host"),
                 lambda: bf.empty_like(np.zeros(4), space="cuda_host")):
        with pytest.raises(bf.BifrostError, match="pinned"):
            make()


# ------------------------------------------------ the guard on prepare
def _prepare_ops():
    """Every port op that lifts numpy input through `prepare` (or, for
    bf.map, through its own lift to the thread's device): name -> a call
    on numpy input returning a tensor."""
    import importlib
    from bifrost_tpu_torch.ops import Fdmt, fftshift, transpose
    from bifrost_tpu_torch.ops.calibrate import calibrate
    from bifrost_tpu_torch.ops.flag import flag
    from bifrost_tpu_torch.ops.reduce import reduce_to
    emap = importlib.import_module("bifrost_tpu_torch.ops.map").map
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    return {
        "calibrate": lambda: calibrate(x, np.ones(4, np.complex64)),
        "fdmt": lambda: Fdmt().init(8, 4, f0=60e6, df=0.1e6).execute(x),
        "fft": lambda: bf.fft.fft(x, axes=1),
        "fftshift": lambda: fftshift(x, axes=0),
        "flag": lambda: flag(x, 4)[0],
        "map": lambda: emap("b = a * 2", {"a": x}, shape=(8, 4)),
        "reduce": lambda: reduce_to(x, (8, 1), "sum"),
        "transpose": lambda: transpose(None, x, axes=(1, 0)),
    }


def _in_fresh_thread(fn):
    """-> (result, exception) of `fn` on a new thread (no device bound)."""
    box = {}

    def run():
        try:
            box["res"] = fn()
        except Exception as e:   # noqa: BLE001 — handed to the test
            box["exc"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    return box.get("res"), box.get("exc")


@pytest.mark.parametrize("op", sorted(_prepare_ops()))
def test_numpy_input_goes_to_the_thread_s_device(op, monkeypatch):
    """Bound to the CPU, the result lies on the CPU; with nothing bound
    it is the card's, and where there is none the op refuses (never a
    silent run on the CPU)."""
    call = _prepare_ops()[op]

    def bound():
        device.set_device("cpu")
        return call()
    res, exc = _in_fresh_thread(bound)
    assert exc is None, exc
    assert isinstance(res, torch.Tensor) and res.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res, exc = _in_fresh_thread(call)
    assert res is None
    assert isinstance(exc, RuntimeError) and "device='cpu'" in str(exc)
