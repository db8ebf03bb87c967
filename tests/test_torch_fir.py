"""The port's streaming FIR (`ops.Fir`, `blocks.fir` / `FirBlock`, on
kernel K2's plain version here) against the JAX package's
(bifrost_tpu/ops/fir.py, bifrost_tpu/blocks/fir.py), on the CPU, on the
same seeded numpy input.

Mirrors tests/test_ops.py:454,468,485,1223,1239,
tests/test_beamform_fir.py:88,102,163,197,217,281,323 and
tests/test_fusion.py:309 (`test_fir_joins_stateful_chain_bitwise`).

Parity tiers:
- the port's 'plain' (and 'cuda', which is the plain version for a CPU
  tensor) against JAX 'jnp': bitwise where input and coefficients are
  integer-exact (every product and partial sum an integer below 2**24);
  elsewhere within 4 ntap 2**-24 M, M = sum_k |x_k| |c_k| per output
  (the f64 magnitude filter): each side is within 2 ntap u M of the
  exact sum (ntap product and ntap sum roundings, u = 2**-24), XLA:CPU
  contracting into FMAs or not;
- 'conv' (F.conv1d) against 'plain': the same bound, its own reduction
  order;
- split gulps against one long gulp, raw against logical, fused against
  unfused: bitwise;
- scipy's lfilter goldens (f64): rtol = atol = 1e-4, as the JAX tests.
"""

import os

import numpy as np
import pytest
import torch

import bifrost_tpu as jbf
from bifrost_tpu import blocks as jblocks
from bifrost_tpu import config as jconfig
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import callback_sink as j_callback_sink
from bifrost_tpu.ops import Fir as JFir
from bifrost_tpu.pipeline import Pipeline as JPipeline

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import blocks, config, proclog
from bifrost_tpu_torch.blocks.testing import (array_source, callback_sink,
                                              gather_sink)
from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.ops import Fir, fir_kernel
from bifrost_tpu_torch.pipeline import Pipeline

EPS = 2.0 ** -24


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for f in ("fir_method", "fir_pallas", "pipeline_fuse",
              "pipeline_async_depth"):
        config.reset(f)


@pytest.fixture
def k2_calls(monkeypatch):
    """Calls of K2's wrapper (on the CPU it runs its plain version; the
    count is the launches the card would make)."""
    from bifrost_tpu_torch.ops import fir as fir_mod
    n = {"fir_mac": 0}
    real = fir_kernel.fir_mac

    def counted(*a, **k):
        n["fir_mac"] += 1
        return real(*a, **k)
    monkeypatch.setattr(fir_mod, "fir_mac", counted)
    return n


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _bits(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _mag(x, coeffs, decim):
    """M = sum_k |xh_k| |c_k| per output (f64), zero history: the scale
    of the f32 rounding bound.  x: (ntime, ...) real or complex; coeffs
    (ntap,) or (ntap, nchan)."""
    x = np.asarray(x)
    t = x.shape[0]
    planes = [np.abs(x.real), np.abs(x.imag)] if np.iscomplexobj(x) \
        else [np.abs(x)]
    c = np.abs(np.asarray(coeffs, np.float64))
    ntap = c.shape[0]
    out = []
    for p in planes:
        p = p.reshape(t, -1).astype(np.float64)
        cc = c.reshape(ntap, -1)
        xp = np.concatenate([np.zeros((ntap - 1, p.shape[1])), p])
        acc = sum(xp[k:k + t] * cc[ntap - 1 - k] for k in range(ntap))
        out.append(acc[::decim].reshape((-1,) + x.shape[1:]))
    return np.maximum(*out) if len(out) == 2 else out[0]


def _close(port, ref, x, coeffs, decim):
    """Within 4 ntap u M of each other (module docstring)."""
    ntap = np.asarray(coeffs).shape[0]
    tol = 4 * ntap * EPS * _mag(x, coeffs, decim)
    d = np.abs(_np(port).astype(np.complex128) -
               np.asarray(ref).astype(np.complex128))
    return d.shape == tol.shape and bool(np.all(d <= tol)), \
        float((d / np.maximum(tol, 1e-30)).max())


# --------------------------------------- tests/test_ops.py: the plan

def test_fir_vs_scipy():
    """Mirrors test_ops.py:454: the plan against scipy's lfilter, and
    against the JAX 'jnp' plan within the rounding bound."""
    scipy_signal = pytest.importorskip("scipy.signal")
    rng = np.random.default_rng(0)
    x = rng.random((256, 3)).astype(np.float32)
    coeffs = rng.random(8)
    plan = Fir()
    plan.init(coeffs, decim=1)
    out = torch.empty(256, 3)
    plan.execute(x, out)
    golden = scipy_signal.lfilter(coeffs, 1.0, x, axis=0)
    np.testing.assert_allclose(out.numpy(), golden, rtol=1e-4, atol=1e-4)
    j = JFir(method="jnp").init(coeffs, decim=1).execute(x)
    ok, worst = _close(out, j, x, coeffs, 1)
    assert ok, worst


def test_fir_state_carry():
    """Mirrors test_ops.py:468: two half-gulps equal one full gulp,
    bitwise, and scipy within 1e-4."""
    scipy_signal = pytest.importorskip("scipy.signal")
    rng = np.random.default_rng(1)
    x = rng.random((128, 2)).astype(np.float32)
    coeffs = rng.random(5)
    plan = Fir().init(coeffs, decim=1)
    o1, o2 = plan.execute(x[:64]), plan.execute(x[64:])
    full = Fir().init(coeffs, decim=1).execute(x)
    assert _bits(torch.cat([o1, o2]), full)
    golden = scipy_signal.lfilter(coeffs, 1.0, x, axis=0)
    np.testing.assert_allclose(full.numpy(), golden, rtol=1e-4, atol=1e-4)


def test_fir_decimation():
    """Mirrors test_ops.py:485: decim 2 keeps every other output."""
    rng = np.random.default_rng(2)
    x = rng.random((64, 1)).astype(np.float32)
    coeffs = np.ones(2) / 2
    out = Fir().init(coeffs, decim=2).execute(x)
    full = np.convolve(np.concatenate([[0.0], x[:, 0]]), coeffs[::-1],
                       mode="valid")
    np.testing.assert_allclose(out.numpy()[:, 0], full[::2], rtol=1e-4,
                               atol=1e-5)


def test_fir_pallas_matches_scipy():
    """Mirrors test_ops.py:1223 (the Pallas kernel in interpret mode):
    the kernel's route, 'cuda', which on a CPU tensor is its plain
    version, against scipy."""
    scipy_signal = pytest.importorskip("scipy.signal")
    rng = np.random.default_rng(13)
    x = rng.random((300, 5)).astype(np.float32)
    coeffs = rng.random(7)
    plan = Fir(method="cuda").init(coeffs, decim=1)
    golden = scipy_signal.lfilter(coeffs, 1.0, x, axis=0)
    np.testing.assert_allclose(plan.execute(x).numpy(), golden, rtol=1e-4,
                               atol=1e-4)


def test_fir_pallas_state_and_decimation():
    """Mirrors test_ops.py:1239: split gulps with decimation on 'cuda'
    bitwise one long gulp on 'plain', and within the bound of the JAX
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(14)
    x = rng.random((512, 3)).astype(np.float32)
    coeffs = rng.random(9)
    ref = Fir(method="plain").init(coeffs, decim=2).execute(x)
    plan = Fir(method="cuda").init(coeffs, decim=2)
    got = torch.cat([plan.execute(x[:256]), plan.execute(x[256:])])
    assert _bits(got, ref)
    jp = JFir(method="pallas")
    jp.pallas_interpret = True
    jp.init(coeffs, decim=2)
    j = np.concatenate([np.asarray(jp.execute(x[:256])),
                        np.asarray(jp.execute(x[256:]))])
    ok, worst = _close(got, j, x, coeffs, 2)
    assert ok, worst


# ---------------------------------- tests/test_beamform_fir.py: ops

def test_fir_pallas_bitwise_vs_jnp_mac():
    """Mirrors test_beamform_fir.py:88: the kernel's route bitwise the
    plain MAC at decim 2, 9 taps; against JAX 'jnp' within the bound on
    random f32 and bitwise on integer-exact input."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((200, 4)).astype(np.float32)
    c = rng.standard_normal((9, 4))
    a = Fir(method="plain").init(c, decim=2).execute(x)
    b = Fir(method="cuda").init(c, decim=2).execute(x)
    assert _bits(a, b)
    j = JFir(method="jnp").init(c, decim=2).execute(x)
    ok, worst = _close(a, j, x, c, 2)
    assert ok, worst
    xi = rng.integers(-8, 8, (200, 4)).astype(np.float32)
    ci = rng.integers(-4, 5, (9, 4)).astype(np.float64)
    assert _bits(Fir(method="plain").init(ci, decim=2).execute(xi),
                 np.asarray(JFir(method="jnp").init(ci, decim=2)
                            .execute(xi)))


def test_fir_raw_split_gulps_bitwise():
    """Mirrors test_beamform_fir.py:102: split ci8 gulps == one long
    gulp, bitwise, and raw == logical; against JAX 'jnp' raw within the
    bound."""
    rng = np.random.default_rng(4)
    raw = rng.integers(-90, 90, (128, 3, 2)).astype(np.int8)
    c = rng.standard_normal((7, 3))
    ra = Fir(method="plain").init(c, decim=2).execute_raw(
        torch.from_numpy(raw), "ci8")
    split = Fir(method="plain").init(c, decim=2)
    h = [split.execute_raw(torch.from_numpy(raw[:64]), "ci8"),
         split.execute_raw(torch.from_numpy(raw[64:]), "ci8")]
    assert _bits(torch.cat(h), ra)
    z = (raw[..., 0].astype(np.float32) + 1j * raw[..., 1]) \
        .astype(np.complex64)
    assert _bits(Fir(method="plain").init(c, decim=2).execute(z), ra)
    j = JFir(method="jnp").init(c, decim=2).execute_raw(raw, "ci8")
    ok, worst = _close(ra, j, z, c, 2)
    assert ok, worst


def test_fir_raw_then_logical_state_continuity():
    """Mirrors test_beamform_fir.py:323: a logical gulp after a raw one
    keeps the carried history (one folded state for both entries)."""
    rng = np.random.default_rng(30)
    raw = rng.integers(-90, 90, (128, 3, 2)).astype(np.int8)
    c = rng.standard_normal((7, 3))
    golden = Fir(method="plain").init(c, decim=2).execute_raw(
        torch.from_numpy(raw), "ci8")
    mixed = Fir(method="plain").init(c, decim=2)
    h1 = mixed.execute_raw(torch.from_numpy(raw[:64]), "ci8")
    z2 = (raw[64:, ..., 0].astype(np.float32) +
          1j * raw[64:, ..., 1]).astype(np.complex64)
    h2 = mixed.execute(z2)
    assert _bits(torch.cat([h1, h2]), golden)


@pytest.mark.parametrize("ntap", [1, 5, 16])
@pytest.mark.parametrize("decim", [1, 2, 4])
@pytest.mark.parametrize("form", ["real", "complex", "ci8", "ci4"])
def test_plain_bitwise_jnp_on_integer_exact_input(form, decim, ntap):
    """The integer-exact tier: int8-valued samples (ci4 values for
    'ci4') and integer coefficients, every partial sum an integer below
    2**24: the port's plain MAC and K2's route bitwise the JAX 'jnp'
    plan, split gulps bitwise one gulp, for real, complex, raw ci8 and
    packed ci4 streams.  Samples and coefficients are nonzero: XLA folds
    the MAC's first add of 0.0 away, so a -0.0 product would keep its
    sign there and not here."""
    rng = np.random.default_rng(100 + ntap * 10 + decim)
    nt = 96
    lo, hi = (-8, 8) if form == "ci4" else (-128, 128)

    def nonzero(shape, a, b):
        v = rng.integers(a, b - 1, shape)
        return np.where(v >= 0, v + 1, v)
    c = nonzero((ntap, 5), -3, 4).astype(np.float64)
    re = nonzero((nt, 5), lo, hi).astype(np.int8)
    im = nonzero((nt, 5), lo, hi).astype(np.int8)
    if form == "real":
        x = re.astype(np.float32)
        j = JFir(method="jnp").init(c, decim=decim).execute(x)
        run = [lambda p, a, b: p.execute(x[a:b])]
    elif form == "complex":
        x = (re + 1j * im.astype(np.float32)).astype(np.complex64)
        j = JFir(method="jnp").init(c, decim=decim).execute(x)
        run = [lambda p, a, b: p.execute(x[a:b])]
    else:
        pairs = np.stack([re, im], -1)
        if form == "ci8":
            raw = pairs
        else:
            raw = ((pairs[..., 0] & 0xF).astype(np.uint8) << 4) | \
                (pairs[..., 1] & 0xF).astype(np.uint8)
        j = JFir(method="jnp").init(c, decim=decim).execute_raw(raw, form)
        run = [lambda p, a, b: p.execute_raw(torch.from_numpy(raw[a:b]),
                                             form)]
    for method in ("plain", "cuda"):
        one = run[0](Fir(method=method).init(c, decim=decim), 0, nt)
        assert _bits(one, np.asarray(j)), (method, form)
        p = Fir(method=method).init(c, decim=decim)
        parts = [run[0](p, a, a + 32) for a in range(0, nt, 32)]
        assert _bits(torch.cat(parts), one)


def test_conv_method_within_bound_of_plain():
    """'conv' (F.conv1d, groups=lanes) against 'plain', real and complex,
    decim 1 and 4, 16 taps: within 4 ntap u M; its history carries."""
    rng = np.random.default_rng(7)
    for decim in (1, 4):
        x = rng.standard_normal((64, 6)).astype(np.float32)
        z = (x + 1j * rng.standard_normal((64, 6))).astype(np.complex64)
        c = rng.standard_normal((16, 6))
        for data in (x, z):
            want = Fir(method="plain").init(c, decim=decim).execute(data)
            p = Fir(method="conv").init(c, decim=decim)
            got = torch.cat([p.execute(data[:32]), p.execute(data[32:])])
            assert got.dtype == want.dtype
            ok, worst = _close(got, want.numpy(), data, c, decim)
            assert ok, (decim, worst)


def test_method_flag_refusals_and_legacy_bool():
    """'pallas' and 'jnp' are refused naming their counterparts; the
    `fir_method` flag resolves 'auto'; `fir_pallas` forces 'cuda';
    an unknown method is refused."""
    with pytest.raises(ValueError, match="K2.*'cuda'"):
        Fir(method="pallas")
    with pytest.raises(ValueError, match="'plain'"):
        Fir(method="jnp")
    with pytest.raises(ValueError, match="unknown method"):
        Fir(method="fft")
    p = Fir().init(np.ones(3))
    assert p._resolve() == "cuda"
    config.set("fir_method", "plain")
    assert p._resolve() == "plain"
    config.set("fir_method", "jnp")
    with pytest.raises(ValueError, match="'plain'"):
        p._resolve()
    config.set("fir_method", "auto")
    config.set("fir_pallas", True)
    assert p._resolve() == "cuda"


def test_plan_report_keys_and_set_coeffs():
    """plan_report has the JAX report's keys; equal coefficients keep the
    staged bank (a cache hit) and reset the history, new ones drop it."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((16, 3)).astype(np.float32)
    c = rng.standard_normal((4, 3))
    p = Fir().init(c)
    p.execute(x)
    j = JFir(method="jnp").init(c)
    j.execute(x)
    rp, rj = p.plan_report(), j.plan_report()
    assert set(rp) == set(rj) and set(rp["cache"]) == set(rj["cache"])
    assert (rp["ntap"], rp["decim"], rp["op"]) == (4, 1, "fir")
    first = p.execute(x)
    p.set_coeffs(c)
    assert p._state is None
    again = p.execute(x)
    assert p.plan_report()["cache"]["misses"] == 1
    assert _bits(again, Fir().init(c).execute(x))
    assert not _bits(first, again)            # the history was reset
    p.set_coeffs(2 * c)
    p.execute(x)
    assert p.plan_report()["cache"]["misses"] == 2


# ------------------------------- tests/test_beamform_fir.py: blocks

def _ci8_stream(ntime, nchan, npol, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-90, 90, (ntime, nchan, npol, 2)).astype(np.int8)
    hdr = {"dtype": "ci8", "labels": ["time", "freq", "pol"],
           "scales": [[0, 1e-3], [1400.0, 1.0], None],
           "units": ["s", "MHz", None]}
    return raw, hdr


def _port_block_run(raw, hdr, gulp, coeffs, decim, space="cuda",
                    method=None, depth=1):
    outs, hdrs = [], []
    config.set("pipeline_async_depth", depth)
    with Pipeline(device="cpu") as pipe:
        src = array_source(raw, gulp, header=dict(hdr))
        dev = blocks.copy(src, space=space) if space == "cuda" else src
        fb = blocks.fir(dev, coeffs, decim=decim, method=method)
        back = blocks.copy(fb, space="system")
        gather_sink(back, outs, hdrs)
        pipe.run()
    config.reset("pipeline_async_depth")
    return np.concatenate(outs, axis=0), hdrs, fb


def test_fir_block_device_ring_raw_read_byte_accounting():
    """Mirrors test_beamform_fir.py:163: a ci8 'cuda' ring is read in
    storage form on every gulp (2 B/sample), the header is cf32 with the
    time scale x decim, the output matches scipy, and is within the bound
    of the JAX block's."""
    scipy_signal = pytest.importorskip("scipy.signal")
    ntime, nchan, npol = 64, 3, 2
    raw, hdr = _ci8_stream(ntime, nchan, npol, 11)
    coeffs = np.random.default_rng(11).standard_normal(5)
    out, hdrs, fb = _port_block_run(raw, hdr, 16, coeffs, 2)
    assert fb._raw_reads == 4, fb._raw_reads
    assert fb._raw_read_nbyte == ntime * nchan * npol * 2
    assert hdrs[0]["_tensor"]["dtype"] == "cf32"
    assert hdrs[0]["_tensor"]["scales"][0][1] == pytest.approx(2e-3)
    z = (raw[..., 0].astype(np.float32) +
         1j * raw[..., 1]).reshape(ntime, nchan * npol)
    golden = scipy_signal.lfilter(coeffs, 1.0, z, axis=0)[::2] \
        .reshape(-1, nchan, npol)
    np.testing.assert_allclose(out, golden, rtol=1e-4, atol=1e-4)
    jouts = []
    with JPipeline() as pipe:
        src = j_array_source(pair_to_structured(raw), 16, header=dict(hdr))
        dev = jblocks.copy(src, space="tpu")
        jfb = jblocks.fir(dev, coeffs, decim=2, method="jnp")
        back = jblocks.copy(jfb, space="system")
        j_callback_sink(back, on_data=lambda a: jouts.append(np.array(a)))
        pipe.run()
    assert jfb._raw_reads == 4
    ok, worst = _close(out, np.concatenate(jouts),
                       z.reshape(ntime, nchan, npol), coeffs, 2)
    assert ok, worst


def test_fir_block_host_ring_f32_matches_scipy():
    """Mirrors test_beamform_fir.py:197: a host-ring real f32 stream,
    per-channel banks, no decimation (the logical path)."""
    scipy_signal = pytest.importorskip("scipy.signal")
    rng = np.random.default_rng(12)
    ntime, nchan = 96, 4
    data = rng.standard_normal((ntime, nchan)).astype(np.float32)
    coeffs = rng.standard_normal((7, nchan))
    out, hdrs, fb = _port_block_run(data, {}, 32, coeffs, 1, space=None)
    assert fb._raw_reads == 0 and hdrs[0]["_tensor"]["dtype"] == "f32"
    golden = np.stack([scipy_signal.lfilter(coeffs[:, c], 1.0, data[:, c])
                       for c in range(nchan)], axis=1)
    np.testing.assert_allclose(out, golden, rtol=1e-4, atol=1e-4)


def test_fir_block_rejects_undivisible_gulp():
    """Mirrors test_beamform_fir.py:217: a gulp that is not a multiple
    of decim is refused at the sequence's start."""
    data = np.zeros((32, 2), np.float32)
    with pytest.raises(Exception, match="multiple of decim"):
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 9)
            blocks.fir(src, np.ones(3), decim=2)
            pipe.run()


def test_fir_block_publishes_plan_proclog():
    """Mirrors test_beamform_fir.py:281: `<name>/fir_plan` carries the
    resolved method, ntap and decim, with the JAX row's keys."""
    rng = np.random.default_rng(15)
    data = rng.standard_normal((32, 3)).astype(np.float32)
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 16)
        fb = blocks.fir(src, np.ones(4) / 4, decim=2)
        gather_sink(fb, [])
        pipe.run()
        rows = proclog.load_by_pid(os.getpid())
    assert fb.name in rows and "fir_plan" in rows[fb.name], list(rows)
    row = rows[fb.name]["fir_plan"]
    assert row["method"] in ("cuda", "plain", "conv")
    assert row["ntap"] == 4 and row["decim"] == 2
    with JPipeline() as jpipe:
        src = j_array_source(data, 16)
        jfb = jblocks.fir(src, np.ones(4) / 4, decim=2, method="jnp")
        j_callback_sink(jfb)
        jpipe.run()
        from bifrost_tpu import proclog as jproclog
        jrow = jproclog.load_by_pid(os.getpid())[jfb.name]["fir_plan"]
    assert set(row) == set(jrow)


def test_fir_method_latched_per_sequence():
    """FirBlock resolves `fir_method` once a sequence and latches it: a
    mid-sequence set is refused naming the block, released after."""
    data = np.arange(64 * 2, dtype=np.float32).reshape(64, 2)
    errs = []

    def poke(_):
        try:
            config.set("fir_method", "plain")
        except RuntimeError as e:
            errs.append(str(e))

    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 16)
        fb = blocks.fir(src, np.ones(3))
        callback_sink(fb, on_data=poke)
        pipe.run()
    assert errs and "fir_method" in errs[0] and fb.name in errs[0]
    assert fb.fir.method == "cuda"
    config.set("fir_method", "plain")


@pytest.mark.parametrize("form", ["ci8", "ci4"])
def test_block_split_gulps_async_and_raw_bitwise(form, k2_calls):
    """FirBlock on a 'cuda' ring, 16 taps, decim 4: gulps of 16 bitwise
    gulps of 64, the executor at depth 4 bitwise depth 1, 'plain'
    bitwise 'cuda'; one K2 call a gulp; packed ci4 read raw at 1
    B/sample."""
    rng = np.random.default_rng(21)
    pairs = rng.integers(-8, 8, (128, 4, 2, 2)).astype(np.int8)
    raw = pairs if form == "ci8" else \
        ((pairs[..., 0] & 0xF).astype(np.uint8) << 4) | \
        (pairs[..., 1] & 0xF).astype(np.uint8)
    hdr = {"dtype": form, "labels": ["time", "station", "pol"]}
    c = rng.standard_normal((16, 8))
    ref, _, fb = _port_block_run(raw, hdr, 64, c, 4)
    assert k2_calls["fir_mac"] == 2
    assert fb._raw_read_nbyte == raw.nbytes
    small, _, _ = _port_block_run(raw, hdr, 16, c, 4)
    deep, _, fbd = _port_block_run(raw, hdr, 16, c, 4, depth=4)
    plain, _, _ = _port_block_run(raw, hdr, 16, c, 4, method="plain")
    assert k2_calls["fir_mac"] == 2 + 8 + 8
    assert fbd._exec_async_depth == 4
    assert ref.shape == (32, 4, 2)
    assert _bits(small, ref) and _bits(deep, ref) and _bits(plain, ref)


# --------------------------- tests/test_fusion.py: stateful_chain

def test_fir_joins_stateful_chain_bitwise(k2_calls):
    """Mirrors test_fusion.py:309: copy -> fir -> fftshift in a fuse
    scope fuses under the stateful_chain rule (the same group as the JAX
    planner's), the history threads through the group's carry, and fused
    == unfused bitwise with the same K2 calls; the raw head (ci8) too."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((48, 6)) +
         1j * rng.standard_normal((48, 6))).astype(np.complex64)
    raw = rng.integers(-90, 90, (48, 6, 2)).astype(np.int8)
    coeffs = np.hanning(5)

    def run(data, hdr, fuse_on):
        config.set("pipeline_fuse", fuse_on)
        got = []
        try:
            with Pipeline(device="cpu") as pipe:
                src = array_source(data, 8, header=dict(hdr))
                with bt.block_scope(fuse=True):
                    dev = blocks.copy(src, space="cuda")
                    f = blocks.fir(dev, coeffs, decim=2)
                    s = blocks.fftshift(f, axes="chan")
                callback_sink(s, on_data=lambda a: got.append(a.clone()))
                before = k2_calls["fir_mac"]
                pipe.run()
                rep = pipe.fusion_report()
            return torch.cat(got), rep, k2_calls["fir_mac"] - before
        finally:
            config.reset("pipeline_fuse")

    lab = {"labels": ["time", "chan"]}
    for data, hdr in ((x, lab), (raw, dict(lab, dtype="ci8"))):
        fused, rep, nf = run(data, hdr, True)
        unfused, _, nu = run(data, hdr, False)
        assert rep["groups"] and rep["groups"][0]["rule"] == \
            "stateful_chain"
        assert not any(r in ("cross_gulp_state", "input_overlap")
                       for r in rep["refused"].values())
        assert nf == nu == 6
        assert _bits(fused, unfused)
    jcfg = []
    with JPipeline() as jpipe:
        src = j_array_source(x, 8, header=dict(lab))
        with jbf.block_scope(fuse=True):
            dev = jblocks.copy(src, space="tpu")
            f = jblocks.fir(dev, coeffs, decim=2, method="jnp")
            s = jblocks.fftshift(f, axes="chan")
        j_callback_sink(s, on_data=lambda a: jcfg.append(np.array(a)))
        jrep = jpipe.fusion_report()
        jpipe.run()
    assert [g["rule"] for g in jrep["groups"]] == \
        [g["rule"] for g in rep["groups"]]
    assert [len(g["constituents"]) for g in jrep["groups"]] == \
        [len(g["constituents"]) for g in rep["groups"]]
    ok, worst = _close(run(x, lab, True)[0], np.concatenate(jcfg),
                       x, coeffs, 2)
    assert ok, worst
    jconfig.reset("pipeline_fuse")
