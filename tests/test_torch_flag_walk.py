"""The flagger's baseline walk of the port (bifrost_tpu_torch.ops.
flag_kernel: W1's plain version and its wrapper) against the JAX plan's
per-window step run under `jax.lax.scan` on the CPU, on the same seeded
numpy windows: the port's `Flag._window_stats` + `flag_walk_plain`
against `Flag._make_step(jnp, m)`.

Tolerances (those of test_torch_flag.py): masks and the warm row equal;
the center and scale rows, and the fill rows taken from the center,
within STATE_TOL of the row's peak, because XLA:CPU contracts the EMA
and the thresholds' ``a*b + c`` into FMAs and the port does not.  The
seeded windows put no decision within an ulp of its threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost_tpu.ops.flag import Flag as JFlag
from bifrost_tpu_torch.ops.flag import Flag
from bifrost_tpu_torch.ops.flag_kernel import (WARM_CAP, flag_walk,
                                               flag_walk_plain)

STATE_TOL = 1e-6
WINDOW, NCELL = 16, 40
OTHER_PARAMS = dict(thresh=4.0, mad_factor=3.0, alpha=0.5)


def _power(rng, n, m, rfi=True):
    """(n, m, NCELL) f32 power: exponential noise at a level per cell;
    with `rfi`, a burst in cells 3 and 17 from window 2 and a steady
    carrier in cell 9 from window 1 (flat power: SK near 0, the median off
    the baseline), both from window 0 in a segment of one window."""
    level = rng.uniform(1.0, 3.0, NCELL)
    pw = rng.exponential(1.0, (n, m, NCELL)) * level
    if rfi:
        b, c = min(2, n - 1), min(1, n - 1)
        pw[b:, :, 3] *= 40.0
        pw[b:, ::2, 17] += 60.0
        pw[c:, :, 9] = 25.0 * level[9]
    return pw.astype(np.float32)


def _warm_state(rng, algo):
    """A carried state of warmed, cold and capped cells: the port's walk
    over 6 clean windows, then cells 0, 5, 10, ... made cold and cells 2,
    11, 20, 29 set one window short of WARM_CAP, cell 21 at it."""
    p = Flag().init(WINDOW, algo=algo)
    pw = torch.from_numpy(_power(rng, 6, WINDOW, rfi=False))
    st = flag_walk_plain(p._window_stats(pw), WINDOW,
                         p.init_state(NCELL), p._params(), algo)[2].numpy()
    st = st.copy()
    st[:, ::5] = 0.0
    st[2, 2::9] = WARM_CAP - 1
    st[2, 21] = WARM_CAP
    return st


def _segments(case, rng):
    """-> (initial state, [(windows (n, m, NCELL), set_params kwargs)])."""
    if case == "tail":
        return None, [(_power(rng, 6, WINDOW), {}),
                      (_power(rng, 1, 5), {}), (_power(rng, 1, 6), {})]
    if case == "set_params":
        return None, [(_power(rng, 4, WINDOW), {}),
                      (_power(rng, 4, WINDOW), OTHER_PARAMS)]
    return case, [(_power(rng, 8, WINDOW), {})]


def _jax_segment(j, pw, state):
    step = j._make_step(jnp, pw.shape[1])
    params = j.staged_params()
    st, (bads, fills) = jax.lax.scan(lambda s, w: step(s, w, params),
                                     jnp.asarray(state), jnp.asarray(pw))
    return np.asarray(bads), np.asarray(fills), np.asarray(st)


def _close(got, want):
    for r in range(len(want)):
        peak = np.abs(want[r]).max()
        assert np.abs(got[r] - want[r]).max() <= STATE_TOL * peak, r


@pytest.mark.parametrize("case", ["cold", "mixed", "tail", "set_params"])
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_walk_matches_jax_scan(algo, case):
    """A cold start; warmed, cold and capped cells at once (a cell at
    WARM_CAP - 1 reaches the cap and stays there); a tail segment of 5
    and of 6 frames after the whole windows; a mid-stream set_params."""
    rng = np.random.default_rng({"mad": 31, "sk": 32}[algo])
    start, segs = _segments(case, rng)
    state = np.zeros((3, NCELL), np.float32) if start is None \
        else _warm_state(rng, algo)
    j = JFlag(method="jnp").init(WINDOW, algo=algo)
    p = Flag().init(WINDOW, algo=algo)
    js, ps = state, torch.from_numpy(state)
    for pw, retune in segs:
        if retune:
            j.set_params(**retune)
            p.set_params(**retune)
        jb, jf, js = _jax_segment(j, pw, js)
        stats = p._window_stats(torch.from_numpy(pw))
        pb, pf, ps = flag_walk_plain(stats, pw.shape[1], ps, p._params(),
                                     algo)
        assert pb.dtype == torch.bool and pb.shape == jb.shape
        assert pf.dtype == torch.float32 and pf.shape == jf.shape
        np.testing.assert_array_equal(pb.numpy(), jb)
        assert jb.any() and not jb.all()
        np.testing.assert_array_equal(ps[2].numpy(), js[2])
        _close(ps[:2].numpy(), js[:2])
        _close(pf.numpy()[None], jf[None])
    if case == "mixed":
        # the capped cells warmed on good windows and stopped at the cap
        assert (ps[2, 2::9].numpy() == WARM_CAP).any()
        assert ps[2, 21].item() == WARM_CAP
        assert (ps[2].numpy() <= WARM_CAP).all()


@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_walk_leaves_the_callers_state(algo):
    """The walk writes a fresh state: the state it was handed (the fused
    group's carry) is unchanged."""
    rng = np.random.default_rng(33)
    p = Flag().init(WINDOW, algo=algo)
    state = torch.from_numpy(_warm_state(rng, algo))
    keep = state.clone()
    stats = p._window_stats(torch.from_numpy(_power(rng, 4, WINDOW)))
    for walk in (flag_walk_plain, flag_walk):
        out = walk(stats, WINDOW, state, p._params(), algo)[2]
        assert torch.equal(state, keep)
        assert out.data_ptr() != state.data_ptr()


@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_flag_walk_on_the_cpu_is_its_plain_version(algo):
    """On CPU tensors the wrapper runs the plain walk (no launch is
    counted), bitwise, also on statistics with row strides (an odd
    window's median is a view of the sort)."""
    rng = np.random.default_rng(34)
    p = Flag().init(WINDOW, algo=algo)
    state = torch.from_numpy(_warm_state(rng, algo))
    for m in (WINDOW, 5):
        stats = p._window_stats(torch.from_numpy(_power(rng, 4, m)))
        before = flag_walk.launches
        got = flag_walk(stats, m, state, p._params(), algo)
        want = flag_walk_plain(stats, m, state, p._params(), algo)
        assert flag_walk.launches == before
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_flag_walk_refuses():
    """Wrong dtypes, shapes, algorithms and devices raise, on the CPU
    too; a tensor on a device that is neither the CPU nor CUDA raises
    with the kernels' device message."""
    n = 4
    med, mad = torch.rand(n, NCELL), torch.rand(n, NCELL)
    cross, state = torch.rand(n), torch.zeros(3, NCELL)
    params = (6.0, 4.0, 0.25)
    ok = ((med, mad, cross), WINDOW, state, params, "mad")
    before = flag_walk.launches
    flag_walk(*ok)
    with pytest.raises(TypeError, match="float32"):
        flag_walk((med.double(), mad, cross), WINDOW, state, params, "mad")
    with pytest.raises(TypeError, match="float32"):
        flag_walk((med, mad, cross), WINDOW, state.half(), params, "mad")
    with pytest.raises(ValueError, match="mad must be"):
        flag_walk((med, mad[:, 1:], cross), WINDOW, state, params, "mad")
    with pytest.raises(ValueError, match="cross must be"):
        flag_walk((med, mad, cross[1:]), WINDOW, state, params, "mad")
    with pytest.raises(ValueError, match="state must be"):
        flag_walk((med, mad, cross), WINDOW, state[:2], params, "mad")
    with pytest.raises(ValueError, match="n >= 1"):
        flag_walk((med[:0], mad[:0], cross[:0]), WINDOW, state, params,
                  "mad")
    with pytest.raises(ValueError, match="statistics"):
        flag_walk((med, mad), WINDOW, state, params, "mad")
    with pytest.raises(ValueError, match="unknown algo"):
        flag_walk((med, mad), WINDOW, state, params, "kurt")
    meta = [t.to("meta") for t in (med, mad, cross, state)]
    with pytest.raises(ValueError, match="one device"):
        flag_walk((meta[0], mad, cross), WINDOW, state, params, "mad")
    with pytest.raises(ValueError, match="unsupported device meta"):
        flag_walk(tuple(meta[:3]), WINDOW, meta[3], params, "mad")
    assert flag_walk.launches == before
