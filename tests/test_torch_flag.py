"""The RFI flagger of the port (bifrost_tpu_torch.ops.flag, blocks.flag,
kernel K5a's plain version) against the JAX package on the CPU, on the
same seeded numpy input: the JAX plan in its 'jnp' method and in
'pallas' under the Pallas interpreter.

Tolerances:
- Masks: equal.  The statistics of u8, ci8 and real f32 power are the
  same IEEE operations on both sides; complex power and the SK sums are
  rounded differently (XLA:CPU contracts re*re + im*im and a*b + c into
  FMAs), which moves a decision only when it sits within an ulp of its
  threshold, and no input here does.
- Outputs: bitwise where the masks are equal (the fill is a select);
  a baseline fill paints the carried center, which agrees as the state
  does.
- Carried state [center, scale, warm]: warm equal; center and scale
  within 1e-6 of each row's peak (a few f32 roundings per window, over
  at most 10 windows).
"""

import numpy as np
import pytest
import torch

from bifrost_tpu.ops import dq_pallas
from bifrost_tpu.ops.flag import Flag as JFlag
from bifrost_tpu.ops.stats import sk_band as j_sk_band
from bifrost_tpu.ops.stats import spectral_kurtosis as j_sk
from bifrost_tpu_torch.ops.dq_kernel import (fill_vectors, masked_fill,
                                             masked_fill_plain)
from bifrost_tpu_torch.ops.flag import Flag, flag
from bifrost_tpu_torch.ops.stats import sk_band, spectral_kurtosis
from bifrost_tpu_torch.weights import carry_over

STATE_TOL = 1e-6


def _inputs(kind, seed=2, ntime=150):
    """Seeded gulps with RFI in a few cells, ntime frames (a tail window
    of 6 frames at window 16)."""
    rng = np.random.default_rng(seed)
    if kind == "u8":
        x = rng.integers(0, 32, (ntime, 40)).astype(np.uint8)
        x[64:, 5] = 250
        x[100:, 7] = 200
        x[30:34, 11] = 255
    elif kind == "f32":
        x = (rng.standard_normal((ntime, 8, 5)) ** 2).astype(np.float32)
        x[80:, 3, 2] += 30.0
    elif kind == "c64":
        x = (rng.standard_normal((ntime, 8, 5)) +
             1j * rng.standard_normal((ntime, 8, 5))).astype(np.complex64)
        x[96:, 3, 1] += 25.0
    else:                                                  # ci8 storage
        x = rng.integers(-20, 20, (ntime, 6, 4, 2)).astype(np.int8)
        x[64:, 2, 1] = 100
    return x


def _jax(algo, method, fill="zero", window=16, **kw):
    j = JFlag(method=method)
    j.pallas_interpret = True
    return j.init(window, algo=algo, fill=fill, **kw)


def _run_jax(j, x, kind):
    if kind == "ci8":
        y, m = j.execute_raw(x, "ci8")
    else:
        y, m = j.execute(x)
    return np.asarray(y), np.asarray(m), np.asarray(j._state)


def _run_port(p, x, kind):
    t = torch.from_numpy(x)
    y, m = p.execute_raw(t, "ci8") if kind == "ci8" else p.execute(t)
    return y.numpy(), m.numpy(), p._state.numpy()


def _state_close(ps, js):
    np.testing.assert_array_equal(ps[2], js[2])
    for r in (0, 1):
        peak = np.abs(js[r]).max()
        assert np.abs(ps[r] - js[r]).max() <= STATE_TOL * peak


@pytest.mark.parametrize("method", ["jnp", "pallas"])
@pytest.mark.parametrize("kind", ["u8", "f32", "c64", "ci8"])
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_flag_matches_jax(algo, kind, method):
    x = _inputs(kind)
    j = _jax(algo, method)
    p = Flag(method="cuda").init(16, algo=algo)
    jy, jm, js = _run_jax(j, x, kind)
    py, pm, ps = _run_port(p, x, kind)
    assert pm.dtype == bool and pm.shape == jm.shape == (10, jm.shape[1])
    np.testing.assert_array_equal(pm, jm)
    assert jm.any() and not jm.all()
    assert py.dtype == jy.dtype and py.shape == jy.shape
    np.testing.assert_array_equal(py, jy)
    _state_close(ps, js)
    # a second gulp runs from the carried baseline
    x2 = _inputs(kind, seed=9, ntime=48)
    jy, jm, js = _run_jax(j, x2, kind)
    py, pm, ps = _run_port(p, x2, kind)
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(py, jy)
    _state_close(ps, js)


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_flag_baseline_fill_matches_jax(algo, kind):
    """fill='baseline' paints the carried center over flagged cells
    (tail window included); a complex stream refuses it."""
    x = _inputs(kind)
    jy, jm, js = _run_jax(_jax(algo, "jnp", fill="baseline"), x, kind)
    py, pm, ps = _run_port(Flag().init(16, algo=algo, fill="baseline"),
                           x, kind)
    np.testing.assert_array_equal(pm, jm)
    rows = np.minimum(np.arange(len(x)) // 16, len(jm) - 1)
    flagged = jm[rows].reshape(py.shape)
    np.testing.assert_array_equal(py[~flagged], jy[~flagged])
    assert flagged.any()
    tol = STATE_TOL * np.abs(js[0]).max() + (0.5 if kind == "u8" else 0)
    assert np.abs(py[flagged].astype(np.float64) -
                  jy[flagged].astype(np.float64)).max() <= tol
    _state_close(ps, js)
    with pytest.raises(ValueError, match="real streams"):
        Flag().init(16, fill="baseline").execute(
            torch.from_numpy(_inputs("c64")))


@pytest.mark.parametrize("mode", ["jnp", "interpret"])
def test_masked_fill_plain_matches_dq_pallas(mode):
    """K5a's plain version on per-window rows against the JAX kernel on
    full-rate planes, bitwise (-0.0, a tail window, both fills)."""
    rng = np.random.default_rng(11)
    ntime, ncell, window = 37, 19, 8
    nrows = -(-ntime // window)
    x = rng.standard_normal((ntime, ncell)).astype(np.float32)
    x[::3, ::4] = -0.0
    mask = rng.random((nrows, ncell)) < 0.3
    fill = rng.standard_normal((nrows, ncell)).astype(np.float32)
    full = np.repeat(np.arange(nrows), window)[:ntime]
    for f in (fill, None):
        fr = np.zeros_like(x) if f is None else f[full]
        want = np.asarray(dq_pallas.masked_fill(
            x, mask[full].astype(np.float32), fr, mode))
        got = masked_fill_plain(torch.from_numpy(x), torch.from_numpy(mask),
                                None if f is None else torch.from_numpy(f),
                                window)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    # a complex gulp is one call: (re, im) of a cell share its mask
    z = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    zero = np.zeros_like(x)
    wr, wi = (np.asarray(dq_pallas.masked_fill(
        p, mask[full].astype(np.float32), zero, mode))
        for p in (z.real.copy(), z.imag.copy()))
    got = masked_fill(torch.from_numpy(z), torch.from_numpy(mask), None,
                      window).numpy()
    np.testing.assert_array_equal(got.real.view(np.uint32),
                                  wr.view(np.uint32))
    np.testing.assert_array_equal(got.imag.view(np.uint32),
                                  wi.view(np.uint32))
    out = torch.empty(2 * ntime, ncell, dtype=torch.complex64)[::2]
    masked_fill(torch.from_numpy(z), torch.from_numpy(mask), None, window,
                out=out)
    np.testing.assert_array_equal(out.numpy(), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("layout,vec", [
    ("contig", True), ("padded", True), ("offset", False),
    ("strided", False), ("rows", False), ("odd_rows", False)])
def test_fill_vectors_predicate(layout, vec, dtype):
    """K5a takes its 16-byte vector kernel only where x and out hold
    their cells contiguously at 16-byte aligned bases and row strides:
    contiguous gulps of 304 cells and the first 301 cells of padded rows
    do; a base one element off alignment, every other cell, a row stride
    off alignment (301 cells of f32 or complex64 rows, every 3rd row)
    and a frame stride that is not a whole row of vectors do not."""
    def span(shape):
        base = torch.empty(0, dtype=dtype).new_empty(shape)
        assert base.data_ptr() % 16 == 0
        return base
    if layout == "contig":
        t = span((6, 304))
    elif layout == "padded":
        t = span((6, 304))[:, :301]
    elif layout == "offset":
        t = span((6, 305))[:, 1:]
    elif layout == "strided":
        t = span((6, 608))[:, ::2]
    elif layout == "rows":
        t = span((6, 301))
    else:
        t = span((18, 301))[::3]
    n, per = t.shape[1], 16 // t.element_size()
    good = span((t.shape[0], -(-n // per) * per))[:, :n]
    assert fill_vectors(good, good)
    assert fill_vectors(t, good) == vec
    assert fill_vectors(good, t) == vec


@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_flag_split_gulp_bitwise_continuity(algo):
    """Split at window multiples (the last part with a tail window) ==
    one long gulp, bitwise (tests/test_dq.py:86-105)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((150, 5)) +
         1j * rng.standard_normal((150, 5))).astype(np.complex64)
    x[96:, 3] += 25.0
    y_w, m_w = Flag().init(16, algo=algo).execute(torch.from_numpy(x))
    two = Flag().init(16, algo=algo)
    ys, ms = [], []
    for lo, hi in ((0, 32), (32, 96), (96, 150)):
        y, m = two.execute(torch.from_numpy(x[lo:hi]))
        ys.append(y)
        ms.append(m)
    np.testing.assert_array_equal(torch.cat(ys).numpy(), y_w.numpy())
    np.testing.assert_array_equal(torch.cat(ms).numpy(), m_w.numpy())
    assert m_w.any()


def test_set_params_retunes_without_losing_the_baseline():
    """set_params mid-stream keeps the carried baseline and takes effect
    at the next window, as the JAX plan's does."""
    x = _inputs("u8")
    j = _jax("mad", "jnp")
    p = Flag().init(16)
    for plan, run in ((j, _run_jax), (p, _run_port)):
        run(plan, x[:64], "u8")
        state = plan._state
        plan.set_params(thresh=2.0, mad_factor=1.5)
        assert plan._state is state
    jy, jm, js = _run_jax(j, x[64:], "u8")
    py, pm, ps = _run_port(p, x[64:], "u8")
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(py, jy)
    _state_close(ps, js)
    assert pm.sum() > _run_port(Flag().init(16), x[64:], "u8")[1].sum()


def test_resume_from_a_jax_carried_state():
    """A port plan resumed from the JAX plan's carried state and
    parameters (weights.carry_over) continues as the JAX plan does."""
    x = _inputs("c64")
    j = _jax("mad", "jnp", thresh=5.0, mad_factor=3.0, alpha=0.5)
    j.execute(x[:80])
    args = carry_over(flag_state=np.asarray(j._state),
                      flag_params=np.asarray(j.staged_params()))
    assert args["flag_params"] == {"thresh": 5.0, "mad_factor": 3.0,
                                   "alpha": 0.5}
    p = Flag().init(16)
    p.set_params(**args["flag_params"])
    p.load_state(args["flag_state"])
    jy, jm, js = _run_jax(j, x[80:], "c64")
    py, pm, ps = _run_port(p, x[80:], "c64")
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(py, jy)
    _state_close(ps, js)
    p2 = Flag().init(16)
    p2.load_state(args["flag_state"])
    with pytest.raises(ValueError, match="cells"):
        p2.execute(torch.zeros(16, 3, dtype=torch.complex64))


def test_flag_one_shot_report_and_refusals():
    x = torch.from_numpy(_inputs("u8"))
    y, m = flag(x, 16)
    p = Flag(method="plain").init(16)
    y2, m2 = p.execute(x)
    assert torch.equal(y, y2) and torch.equal(m, m2)
    rep = p.plan_report()
    assert rep["op"] == "flag" and rep["method"] == "plain"
    assert (rep["algo"], rep["window"], rep["fill"]) == ("mad", 16, "zero")
    with pytest.raises(ValueError, match="window"):
        Flag().init(1)
    with pytest.raises(ValueError, match="algo"):
        Flag().init(16, algo="kurt")
    with pytest.raises(ValueError, match="method"):
        Flag(method="pallas")
    # ci4 storage through execute_raw: bitwise its ci8 twin.
    rng = np.random.default_rng(2)
    re = rng.integers(-8, 8, (64, 3, 2)).astype(np.int8)
    im = rng.integers(-8, 8, (64, 3, 2)).astype(np.int8)
    packed = torch.from_numpy(((re & 0xF).astype(np.uint8) << 4) |
                              (im & 0xF).astype(np.uint8))
    pairs = torch.from_numpy(np.stack([re, im], -1))
    y4, m4 = Flag(method="plain").init(16).execute_raw(packed, "ci4")
    y8, m8 = Flag(method="plain").init(16).execute_raw(pairs, "ci8")
    assert y4.shape == (64, 3, 2) and y4.dtype == torch.complex64
    assert torch.equal(y4, y8) and torch.equal(m4, m8)


def test_spectral_kurtosis_and_band_vs_jax():
    """The SK golden of tests/test_dq.py:30-53 and the JAX numpy forms."""
    rng = np.random.default_rng(0)
    M, NC = 512, 7
    v = rng.standard_normal((M, NC)) + 1j * rng.standard_normal((M, NC))
    pwr = np.abs(v) ** 2
    sk = spectral_kurtosis(torch.from_numpy(pwr), dim=0).numpy()
    golden = ((M + 1.0) / (M - 1.0)) * \
        (np.var(pwr, axis=0) / np.mean(pwr, axis=0) ** 2)
    np.testing.assert_allclose(sk, golden, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(sk, j_sk(pwr, axis=0), rtol=1e-12)
    for m, t in ((M, 3.0), (16, 6.0), (7, 2.5)):
        assert sk_band(m, t) == j_sk_band(m, t)
    lo, hi = sk_band(M, thresh=3.0)
    assert np.all(sk > lo) and np.all(sk < hi)
    pulsed = pwr.copy()
    pulsed[:, 3] = np.where(rng.random(M) < 0.1, 300.0, 1e-3)
    assert spectral_kurtosis(torch.from_numpy(pulsed))[3] > hi
    with pytest.raises(ValueError, match="2 samples"):
        spectral_kurtosis(torch.ones(1, 4))


# ---------------------------------------------------------------- block
def _jax_block(x, header, gulp, **kw):
    from bifrost_tpu import blocks
    from bifrost_tpu.blocks.testing import array_source, gather_sink
    from bifrost_tpu.pipeline import Pipeline
    got, hdrs = [], []
    with Pipeline() as pipe:
        src = array_source(x, gulp, header=header)
        fl = blocks.rfi_flag(blocks.copy(src, space="tpu"), **kw)
        gather_sink(blocks.copy(fl, space="system"), got, hdrs)
        pipe.run()
    return np.concatenate(got), hdrs[0], fl


def _port_block(x, header, gulp, masks=None, **kw):
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    got, hdrs = [], []
    with Pipeline(device="cpu") as pipe:
        src = blocks.array_source(x, gulp, header=header)
        fl = blocks.rfi_flag(blocks.copy(src, space="cuda"),
                             on_mask=None if masks is None else masks.append,
                             **kw)
        blocks.gather_sink(fl, got, hdrs)
        pipe.run()
    return np.concatenate(got), hdrs[0], fl


@pytest.mark.parametrize("kind,window", [("u8", 16), ("c64", 16),
                                         ("ci8", None), ("f32", 8)])
def test_flag_block_matches_jax_block(kind, window):
    """The block against the JAX block: outputs, the last mask, the
    flagged fraction, the output header; a ci8 'cuda' ring read in raw
    storage form; window None is one window per gulp."""
    from bifrost_tpu_torch.ndarray import pair_to_structured
    x = _inputs(kind, ntime=160)
    cells = x.shape[1:-1] if kind == "ci8" else x.shape[1:]
    labels = ["time"] + [f"ax{i}" for i in range(1, len(cells) + 1)]
    hdr = {"labels": labels}
    jx = x
    if kind == "ci8":
        hdr["dtype"] = "ci8"
        jx = pair_to_structured(x)
    want, jhdr, jfl = _jax_block(jx, dict(hdr), 32, window=window)
    masks = []
    got, phdr, pfl = _port_block(x, dict(hdr), 32, masks, window=window)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pfl.last_mask, jfl.last_mask)
    assert pfl.flagged_fraction == jfl.flagged_fraction > 0
    assert pfl.baseline_resets == jfl.baseline_resets == 1
    assert phdr["_tensor"]["dtype"] == jhdr["_tensor"]["dtype"]
    assert len(masks) == 5 and masks[-1].shape[1:] == cells
    assert pfl._raw_reads == (5 if kind == "ci8" else 0)
    assert pfl.plan_report()["window"] == (window or 32)
