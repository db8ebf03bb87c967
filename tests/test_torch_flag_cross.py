"""The flagger's cross-cell median MAD in the port (bifrost_tpu_torch.ops.
flag_kernel: W1m's wrapper `flag_cross` and its plain version, and
where `Flag._window_stats` takes it) against the JAX step's
``jnp.median(mad_g)`` (bifrost_tpu/ops/flag.py:198) on the CPU, on the
same seeded numpy MAD rows.

Tolerances: bitwise where a row holds no NaN.  The MADs are
non-negative, so the plain version's float sort and W1m's key select
pick the same values, and ``jnp.median`` averages the same two middle
values for an even count.  A row with NaNs: the port sorts every NaN
last and takes the middle of the order (as `stats.median` always has),
where ``jnp.median`` gives NaN; those rows are held to `stats.median`,
with a NaN compared as a NaN.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifrost_tpu_torch.ops.flag import Flag
from bifrost_tpu_torch.ops.flag_kernel import (CROSS_GRID_ROWS,
                                               CROSS_ROW_CELLS, cross_form,
                                               flag_cross, flag_cross_plain,
                                               flag_stats_plain)
from bifrost_tpu_torch.ops.stats import median


def _mads(rng, n, ncell, m=16):
    """(n, ncell) f32 MAD rows: the window MADs of seeded exponential
    power at a level per cell, as W1s's plain version computes them;
    a few cells of each row flat (MAD 0)."""
    pw = rng.exponential(1.0, (n, m, ncell)) * rng.uniform(0.5, 4.0, ncell)
    pw[:, :, ::5] = 3.0
    mad = flag_stats_plain(torch.from_numpy(pw.astype(np.float32)),
                           "mad")[1]
    assert (mad >= 0).all()
    return mad.numpy()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("ncell", [1, 2, 7, 40, 41, 4096, 4097])
def test_cross_matches_jnp_median(ncell):
    """W1m's wrapper on the CPU and its plain version against the JAX
    step's ``jnp.median`` of the same MAD rows, bitwise: odd and even
    cell counts, one cell (the median the MAD itself), ties at 0."""
    rng = np.random.default_rng(10 + ncell)
    mad = _mads(rng, 6, ncell)
    want = np.asarray(jnp.median(jnp.asarray(mad), axis=1))
    for got in (flag_cross(torch.from_numpy(mad)),
                flag_cross_plain(torch.from_numpy(mad))):
        assert got.shape == (6,) and got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if ncell == 1:
        np.testing.assert_array_equal(_bits(want), _bits(mad[:, 0]))


def test_cross_of_rows_with_nans():
    """Rows with NaN MADs (a window whose samples were NaN): the median of
    the order with every NaN last, as `stats.median` takes it; a row
    whose middle falls on a NaN gives NaN; no NaN in the others."""
    nan = np.float32(np.nan)
    mad = np.array([[1.0, nan, 3.0, 2.0, 0.0],
                    [nan, nan, nan, 1.0, 2.0],
                    [0.5, 0.25, nan, nan, 0.0],
                    [nan] * 5], np.float32)
    got = flag_cross(torch.from_numpy(mad)).numpy()
    np.testing.assert_array_equal(got, [2.0, np.nan, 0.5, np.nan])
    np.testing.assert_array_equal(
        got, median(torch.from_numpy(mad), dim=1, keepdim=False).numpy())
    even = np.array([[1.0, nan, 3.0, 2.0]], np.float32)
    assert flag_cross(torch.from_numpy(even)).item() == 2.5


def test_flag_cross_on_the_cpu_is_its_plain_version():
    """On a CPU tensor the wrapper is the plain version (no launch is
    counted), through strided views."""
    rng = np.random.default_rng(20)
    mad = torch.from_numpy(_mads(rng, 5, 64))
    before = flag_cross.launches
    for x in (mad, mad[:, ::2], mad.t().contiguous().t()):
        got, want = flag_cross(x), flag_cross_plain(x)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert flag_cross.launches == before


def test_flag_cross_refuses():
    """Dtypes, ranks, empty rows or no rows, and devices raise."""
    x = torch.rand(3, 8)
    with pytest.raises(TypeError, match="float32"):
        flag_cross(x.double())
    with pytest.raises(ValueError, match="n >= 1"):
        flag_cross(x[0])
    with pytest.raises(ValueError, match="n >= 1"):
        flag_cross(x[:0])
    with pytest.raises(ValueError, match="ncell >= 1"):
        flag_cross(x[:, :0])
    with pytest.raises(ValueError, match="unsupported device meta"):
        flag_cross(x.to("meta"))


@pytest.mark.parametrize("ncell,form", [
    (1, "row"), (4096, "row"), (CROSS_ROW_CELLS, "row"),
    (CROSS_ROW_CELLS + 1, "grid"), (2_097_152, "grid")])
def test_cross_form(ncell, form):
    """W1m's form by the row's length: a block a row up to
    CROSS_ROW_CELLS cells ([frbflag]'s 4096), a grid a row above ([dq]'s
    2,097,152 cells), in launches of CROSS_GRID_ROWS rows."""
    assert cross_form(ncell) == form
    assert CROSS_GRID_ROWS == 65535


@pytest.mark.parametrize("window", [16, 40])
def test_window_stats_take_the_cross_median_on_both_methods(window):
    """`Flag._window_stats` appends the cross-cell median of its MAD rows:
    W1m's wrapper under 'cuda' (its plain version on the CPU), and
    `stats.median` under 'plain', bitwise equal; 'sk' takes none."""
    rng = np.random.default_rng(30 + window)
    pw = torch.from_numpy(
        rng.exponential(1.0, (3, window, 50)).astype(np.float32))
    got = [Flag(m).init(window)._window_stats(pw, kernel=m == "cuda")
           for m in ("cuda", "plain")]
    assert len(got[0]) == len(got[1]) == 3
    assert torch.equal(got[0][2].view(torch.int32),
                       got[1][2].view(torch.int32))
    assert torch.equal(got[1][2], median(got[1][1], dim=1, keepdim=False))
    assert len(Flag().init(window, algo="sk")._window_stats(pw, True)) == 2
