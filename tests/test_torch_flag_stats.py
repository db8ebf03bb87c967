"""The flagger's window statistics of the port (bifrost_tpu_torch.ops.
flag_kernel: W1s's plain version and its wrapper, and the form
`Flag._windows` takes) against the JAX plan's per-window step on the
CPU, on the same seeded numpy power.

Tolerances:
- Window medians, MADs and the cross-cell median MAD: bitwise for
  power-of-two windows, where ``jnp.median`` sorts exactly as numpy does
  (bifrost_tpu/ops/stats.py), on inputs with no tie between -0.0 and
  +0.0; within STATE_TOL of the row's peak for other windows, whose
  ``jnp.median`` takes another path.
- SK and the window mean: within STATE_TOL of the row's peak.  The port
  sums S1 and S2 over the frames in W1s's tree (frame order up to 32
  frames, chunks of 32 in order above; held bitwise to `_np_tree`);
  XLA:CPU sums in its own order and contracts ``x * x + s`` into FMAs.
- Against the torch-sort pass W1s replaces (`stats.median`): bitwise on
  inputs with no zero-sign tie and no NaN (a NaN median comes back as
  the canonical 0x7fffffff, whatever the NaN in the window).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost_tpu.ops.flag import Flag as JFlag
from bifrost_tpu_torch.ops.flag import Flag
from bifrost_tpu_torch.ops.flag_kernel import (FAN, STATS_MAX_M,
                                               flag_stats, flag_stats_plain,
                                               stats_form)
from bifrost_tpu_torch.ops.stats import median, spectral_kurtosis

STATE_TOL = 1e-6
NCELL = 40
WINDOWS = [2, 5, 12, 16, 17, 32]


def _power(rng, n, m, ncell=NCELL):
    """(n, m, ncell) f32 exponential power at a level per cell, a burst in
    cell 3 and a flat carrier in cell 9."""
    pw = rng.exponential(1.0, (n, m, ncell)) * rng.uniform(1.0, 3.0, ncell)
    pw[:, :, 3] *= 40.0
    pw[:, :, 9] = 25.0
    return pw.astype(np.float32)


def _jax_stats(pw, algo):
    """The JAX step's statistics of each window (bifrost_tpu/ops/flag.py
    `_make_step`: :190-191 and :198 for 'mad', :213-217 for 'sk'),
    window by window."""
    m = pw.shape[1]
    mf = float(m)
    rows = []
    for xw in jnp.asarray(pw):
        if algo == "mad":
            med = jnp.median(xw, axis=0)
            mad = jnp.median(jnp.abs(xw - med[None, :]), axis=0)
            rows.append((med, mad, jnp.median(mad)))
        else:
            s1 = xw.sum(axis=0)
            s2 = (xw * xw).sum(axis=0)
            sk = ((mf + 1.0) / (mf - 1.0)) * \
                (mf * s2 / (s1 * s1 + 1e-6) - 1.0)
            rows.append((sk, s1 / mf))
    return [np.stack([np.asarray(r[k]) for r in rows])
            for k in range(len(rows[0]))]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _close(got, want):
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= STATE_TOL * peak


@pytest.mark.parametrize("m", WINDOWS)
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_stats_match_the_jax_step(algo, m):
    """W1s's plain version (and the cross-cell median the flagger takes
    of its MAD rows) against the statistics of the JAX step."""
    rng = np.random.default_rng(100 + m)
    pw = _power(rng, 6, m)
    got = [t.numpy() for t in flag_stats_plain(torch.from_numpy(pw), algo)]
    want = _jax_stats(pw, algo)
    if algo == "mad":
        got.append(median(torch.from_numpy(got[1]), dim=1,
                          keepdim=False).numpy())
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            if m & (m - 1) == 0:
                np.testing.assert_array_equal(_bits(g), _bits(w))
            else:
                _close(g, w)
    else:
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.float32
            _close(g, w)


@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_stats_drive_the_jax_step(algo):
    """The JAX step under `jax.lax.scan` from a cold baseline paints its
    window statistic as the fill of the first window (the median, or
    the mean) and, for 'sk', carries SK as the scale: the port's
    statistics agree with those the step computed itself."""
    rng = np.random.default_rng(7)
    pw = _power(rng, 1, 16)
    j = JFlag(method="jnp").init(16, algo=algo)
    step = j._make_step(jnp, 16)
    params = j.staged_params()
    st, (_, fills) = jax.lax.scan(lambda s, w: step(s, w, params),
                                  jnp.zeros((3, NCELL), jnp.float32),
                                  jnp.asarray(pw))
    got = flag_stats_plain(torch.from_numpy(pw), algo)
    if algo == "mad":
        np.testing.assert_array_equal(_bits(got[0].numpy()[0]),
                                      _bits(np.asarray(fills)[0]))
    else:
        _close(got[1].numpy()[0], np.asarray(fills)[0])
        _close(got[0].numpy()[0], np.asarray(st)[1])


@pytest.mark.parametrize("m", WINDOWS)
def test_mad_bitwise_the_torch_sort_pass(m):
    """'mad' against the torch-sort pass it replaces (`stats.median` of
    the samples, then of |x - med|), bitwise, on windows with ties, no
    zero-sign tie and no NaN; through strided views too."""
    rng = np.random.default_rng(200 + m)
    pw = _power(rng, 5, m)
    pw[:, :, 20:30] = rng.integers(0, 4, (5, m, 10))       # ties
    pw[:, :, 30] = -pw[:, :, 30]
    for x in (torch.from_numpy(pw),
              torch.from_numpy(np.ascontiguousarray(
                  pw.transpose(2, 1, 0))).permute(2, 1, 0)):
        med, mad = flag_stats_plain(x, "mad")
        m0 = median(x, dim=1, keepdim=True)
        m1 = median((x - m0).abs(), dim=1, keepdim=False)
        assert torch.equal(med.view(torch.int32),
                           m0[:, 0].contiguous().view(torch.int32))
        assert torch.equal(mad.view(torch.int32), m1.view(torch.int32))


def test_sk_within_tolerance_of_the_torch_pass():
    """'sk' against the torch pass it replaces (`spectral_kurtosis` and
    the mean by `sum`): another summation order, within STATE_TOL."""
    rng = np.random.default_rng(300)
    x = torch.from_numpy(_power(rng, 8, 16))
    sk, mean = flag_stats_plain(x, "sk")
    _close(sk.numpy(), spectral_kurtosis(x, dim=1).numpy())
    _close(mean.numpy(), (x.sum(dim=1) / 16).numpy())


def _one(window, algo="mad"):
    x = torch.tensor(np.array(window, np.float32)).reshape(1, -1, 1)
    return [t.item() for t in flag_stats_plain(x, algo)]


def test_key_order():
    """The total order: NaN samples of either sign last, -0.0 before
    +0.0, and all-equal windows."""
    nan, ninf = float("nan"), float("-inf")
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    assert np.isnan(neg_nan) and np.signbit(neg_nan)
    # NaNs of both signs sort last: 1, 3, 5, NaN, NaN; deviations 4, 2,
    # 0, NaN, NaN
    assert _one([5.0, nan, 1.0, neg_nan, 3.0]) == [5.0, 4.0]
    assert _one([neg_nan, 2.0, 1.0]) == [2.0, 1.0]
    # a NaN in the middle gives the canonical NaN
    med, mad = _one([nan, neg_nan, 1.0])
    assert np.isnan(med) and np.isnan(mad)
    med = flag_stats_plain(torch.from_numpy(np.array(
        [nan, neg_nan, 1.0], np.float32).reshape(1, 3, 1)), "mad")[0]
    assert med.view(torch.int32).item() == 0x7FFFFFFF
    # -0.0 before +0.0
    med, mad = _one([0.0, -0.0, -0.0])
    assert med == 0.0 and np.signbit(med) and mad == 0.0
    med, _ = _one([-0.0, 0.0, 0.0])
    assert med == 0.0 and not np.signbit(med)
    med, _ = _one([0.0, -0.0])
    assert med == 0.0 and not np.signbit(med)          # (-0 + +0) / 2
    med, _ = _one([-0.0, -0.0, 0.0, 0.0, 1.0, -1.0])
    assert med == 0.0 and not np.signbit(med)
    med, _ = _one([-0.0, -0.0, -0.0, 0.0, 1.0, -1.0])
    assert med == 0.0 and np.signbit(med)
    # infinities order as values
    assert _one([ninf, 1.0, 2.0]) == [1.0, 1.0]
    # all-equal windows
    for v in (7.5, -0.0, 0.0):
        med, mad = _one([v] * 12)
        assert med == v and np.signbit(med) == np.signbit(v) and mad == 0.0
    med, mad = _one([nan] * 4)
    assert np.isnan(med) and np.isnan(mad)


def test_one_frame_windows():
    """A tail window of one frame: 'mad' takes it (median the sample, MAD
    0); 'sk' needs two frames, as the JAX step's (m + 1) / (m - 1)."""
    x = torch.tensor([[[3.0, -0.0]]])
    med, mad = flag_stats_plain(x, "mad")
    assert torch.equal(med.view(torch.int32), x[:, 0].view(torch.int32))
    assert torch.equal(mad, torch.zeros(1, 2))
    with pytest.raises(ValueError, match="at least 2"):
        flag_stats(x, "sk")


def test_flag_stats_on_the_cpu_is_its_plain_version():
    """On a CPU tensor the wrapper is the plain version (no launch is
    counted), for both algorithms, through strided views."""
    rng = np.random.default_rng(400)
    pw = torch.from_numpy(_power(rng, 4, 12, 24))
    before = flag_stats.launches
    for x in (pw, pw[:, :, ::2], pw.transpose(0, 1).contiguous()
              .transpose(0, 1)):
        for algo in ("mad", "sk"):
            got, want = flag_stats(x, algo), flag_stats_plain(x, algo)
            assert len(got) == 2
            for a, b in zip(got, want):
                assert a.dtype == torch.float32 and torch.equal(a, b)
    assert flag_stats.launches == before


def test_flag_stats_refuses():
    """Dtypes, ranks, windows of no frame, unknown algorithms and devices
    raise; windows past STATS_MAX_M are taken (the select form)."""
    x = torch.rand(2, 8, 5)
    with pytest.raises(TypeError, match="float32"):
        flag_stats(x.double(), "mad")
    with pytest.raises(ValueError, match="n >= 1"):
        flag_stats(x[0], "mad")
    with pytest.raises(ValueError, match="n >= 1"):
        flag_stats(x[:0], "mad")
    with pytest.raises(ValueError, match="at least 1"):
        flag_stats(torch.rand(2, 0, 5), "mad")
    assert len(flag_stats(torch.rand(2, STATS_MAX_M + 1, 5), "mad")) == 2
    with pytest.raises(ValueError, match="unknown algo"):
        flag_stats(x, "kurt")
    with pytest.raises(ValueError, match="unsupported device meta"):
        flag_stats(x.to("meta"), "mad")


@pytest.mark.parametrize("window,routes", [
    (16, ["registers", "registers"]), (32, ["registers", "registers"]),
    (40, ["select", "registers"]), (75, ["select"])])
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_stats_route_and_the_jax_plan(algo, window, routes):
    """W1s's form of each segment's statistics, by its length (a
    150-frame gulp: the whole windows, then a tail), in `plan_report()`;
    the flagger in either form against the JAX plan (masks equal, state
    within STATE_TOL, as test_torch_flag.py holds them)."""
    rng = np.random.default_rng(500 + window)
    x = rng.integers(0, 32, (150, NCELL)).astype(np.uint8)
    x[64:, 5] = 250
    x[:, 7] = 200
    j = JFlag(method="jnp").init(window, algo=algo)
    p = Flag().init(window, algo=algo)
    assert p.plan_report()["stats_route"] == []
    jy, jm = j.execute(x)
    py, pm = p.execute(torch.from_numpy(x))
    assert p.plan_report()["stats_route"] == routes
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    js, ps = np.asarray(j._state), p._state.numpy()
    np.testing.assert_array_equal(ps[2], js[2])
    for r in (0, 1):
        _close(ps[r], js[r])


def test_plain_and_cuda_methods_share_the_statistics():
    """On the CPU both methods take the plain statistics: 'cuda' and
    'plain' bitwise equal, gulp after gulp, on windows of 12 (no
    power-of-two shortcut)."""
    rng = np.random.default_rng(600)
    a, b = Flag("cuda").init(12), Flag("plain").init(12)
    for g in range(3):
        x = torch.from_numpy(_power(rng, 1, 100, NCELL)[0])
        ya, ma = a.execute(x)
        yb, mb = b.execute(x)
        assert torch.equal(ma, mb) and torch.equal(ya, yb)
        assert torch.equal(a._state.view(torch.int32),
                           b._state.view(torch.int32))


def _np_tree(x):
    """x (n, L, ncell) f32 summed over dim 1 in W1s's stated order
    (csrc/flag.cu), in numpy f32 arithmetic: chunks of FAN frames each
    summed in order, then the chunk sums likewise, until one remains."""
    x = np.asarray(x, np.float32)
    while True:
        sums = []
        for k in range(0, x.shape[1], FAN):
            c = x[:, k:k + FAN]
            s = c[:, 0].copy()
            for j in range(1, c.shape[1]):
                s = s + c[:, j]
            sums.append(s)
        x = np.stack(sums, axis=1)
        if x.shape[1] == 1:
            return x[:, 0]


def _same(a, b):
    """Equal values, the sign of zero equal, NaN equal to NaN."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True) \
        and np.array_equal(np.signbit(a) | np.isnan(a),
                           np.signbit(b) | np.isnan(b))


@pytest.mark.parametrize("m", [STATS_MAX_M + 1, 40, 256])
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_torch_route_keeps_the_key_order(algo, m):
    """A window above STATS_MAX_M takes W1s's select form, in place of
    the "torch" route it had before: `_window_stats` on the 'cuda' and
    'plain' methods alike gives `flag_stats_plain`'s statistics, for
    'mad' the key sorts (-0.0 before +0.0, NaNs of either sign last as
    the canonical NaN) and the cross-cell median of `stats.median`, for
    'sk' the sums in the tree `_np_tree` states, bitwise; 'sk' within
    STATE_TOL of `spectral_kurtosis`'s batched sums."""
    rng = np.random.default_rng(700 + m)
    pw = _power(rng, 2, m)
    pw[:, :, 11] = rng.choice(np.array([0.0, -0.0], np.float32), (2, m))
    pw[0, : m // 2 + 1, 13] = -0.0
    pw[0, m // 2 + 1:, 13] = 0.0
    pw[1, ::3, 17] = np.nan
    pw[1, 1::3, 17] = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    x = torch.from_numpy(pw)
    want = flag_stats_plain(x, algo)
    assert stats_form(m) == "select"
    for method in ("cuda", "plain"):
        p = Flag(method).init(m, algo=algo)
        got = p._window_stats(x, kernel=method == "cuda")
        assert len(got) == len(want) + (algo == "mad")
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        if algo == "mad":
            assert torch.equal(got[2], median(want[1], dim=1,
                                              keepdim=False))
    if algo == "mad":
        assert np.signbit(want[0][0, 13].item())
        assert want[0][1, 17].view(torch.int32).item() == 0x7FFFFFFF
    else:
        s1, s2 = _np_tree(pw), _np_tree(pw * pw)
        assert _same(want[1].numpy(), s1 / np.float32(m))
        keep = ~np.isnan(pw).any(axis=1)
        _close(want[0].numpy()[keep], spectral_kurtosis(x, dim=1)
               .numpy()[keep])
        assert _same(s2, _np_tree(pw * pw))


@pytest.mark.parametrize("m", [2, 17, 32, 33, 64, 1024, 1025, 2080,
                               32769])
def test_sk_sums_follow_the_stated_tree(m):
    """'sk''s S1 and S2 in W1s's tree, bitwise `_np_tree` (frame order
    up to 32 frames, the register form's; chunks of 32, then chunks of
    chunk sums, at 33 to 32,769 frames: up to four levels), through a
    strided view too; SK and the mean from them as the plain version
    states."""
    rng = np.random.default_rng(800 + m)
    pw = _power(rng, 2, m, 12)
    pw[0, :, 1] = -0.0
    s1, s2 = _np_tree(pw), _np_tree(pw * pw)
    f32 = np.float32
    mf = f32(m)
    sk = f32((m + 1.0) / (m - 1.0)) * (mf * s2 / (s1 * s1 + f32(1e-6))
                                       - f32(1.0))
    for x in (torch.from_numpy(pw), torch.from_numpy(np.ascontiguousarray(
            pw.transpose(2, 1, 0))).permute(2, 1, 0)):
        got_sk, got_mean = flag_stats_plain(x, "sk")
        assert _same(got_mean.numpy(), s1 / mf)
        assert _same(got_sk.numpy(), sk)
    assert np.signbit(s1[0, 1])


@pytest.mark.parametrize("m", [33, 40, 64, 75, 150])
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_long_window_stats_match_the_jax_step(algo, m):
    """The select form's statistics (its plain version, and the
    cross-cell median of its MAD rows) against the JAX step's, as
    `test_stats_match_the_jax_step` holds the register form's."""
    rng = np.random.default_rng(900 + m)
    pw = _power(rng, 3, m)
    got = [t.numpy() for t in flag_stats_plain(torch.from_numpy(pw), algo)]
    want = _jax_stats(pw, algo)
    if algo == "mad":
        got.append(median(torch.from_numpy(got[1]), dim=1,
                          keepdim=False).numpy())
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        if algo == "mad" and m & (m - 1) == 0:
            np.testing.assert_array_equal(_bits(g), _bits(w))
        else:
            _close(g, w)


@pytest.mark.parametrize("window", [33, 40, 75, None])
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_long_windows_against_the_jax_plan(algo, window):
    """The flagger with windows above STATS_MAX_M (33, 40 and 75 frames,
    and None: one window a 150-frame gulp, as the flag block's default
    makes it) against the JAX plan at method 'jnp', two gulps from the
    carried baseline: masks and outputs equal, state within STATE_TOL;
    'cuda' and 'plain' bitwise equal."""
    w = 150 if window is None else window
    rng = np.random.default_rng(1000 + w)
    j = JFlag(method="jnp").init(w, algo=algo)
    ps = [Flag(m).init(w, algo=algo) for m in ("cuda", "plain")]
    for g in range(2):
        x = rng.integers(0, 32, (150, NCELL)).astype(np.uint8)
        x[40 + 50 * g:, 5] = 250
        x[:, 7] = 200 if g else 30
        jy, jm = j.execute(x)
        (py, pm), (qy, qm) = [p.execute(torch.from_numpy(x)) for p in ps]
        assert ps[0].plan_report()["stats_route"][0] == "select"
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
        assert torch.equal(pm, qm) and torch.equal(py, qy)
        assert torch.equal(ps[0]._state.view(torch.int32),
                           ps[1]._state.view(torch.int32))
        js, st = np.asarray(j._state), ps[0]._state.numpy()
        np.testing.assert_array_equal(st[2], js[2])
        for r in (0, 1):
            _close(st[r], js[r])
