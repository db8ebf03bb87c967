"""The port's FDMT (bifrost_tpu_torch.ops.fdmt) against the JAX package's,
on the same numpy input.

Plans must be identical table for table.  Execution must be BITWISE equal
to JAX `Fdmt(method='pallas')` (the Pallas kernel in interpret mode on
the CPU) and to `method='scan'`: every output element is the same chain
of f32 adds in the same order, so no tolerance applies — on random f32
input as well as on integer-valued input.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu.ops import Fdmt as JaxFdmt
from bifrost_tpu_torch.ops import Fdmt, plan_from_reference
from bifrost_tpu_torch.ops import fdmt_kernel

# tests/test_ops.py's FDMT geometries, and the LWA FRB-search geometry
GEOMETRIES = [
    (16, 32, 60e6, 0.1e6, -2.0),
    (32, 64, 60e6, 0.05e6, -2.0),
    (13, 24, 60e6, 0.1e6, -2.0),       # odd band carry-through
    (16, 32, 61.6e6, -0.1e6, -2.0),    # negative df (reversed band)
    (16, 32, 60e6, 0.1e6, -2.5),       # generic exponent
    (1, 8, 60e6, 0.1e6, -2.0),         # no merge steps
    (64, 128, 60e6, 0.1e6, -2.0),      # k = 2 buckets
    (4096, 2048, 40.0, 0.00928, -2.0),  # lwa_frb_search_spec, max_delay 2048
]

EXEC_GEOMETRIES = [(n, d, f0, df, e, nt) for (n, d, f0, df, e), nt in zip(
    GEOMETRIES[:7], (128, 256, 100, 128, 128, 64, 160))]


def _plans(nchan, max_delay, f0, df, exponent, jax_method="scan"):
    ref = JaxFdmt()
    ref.pallas_interpret = True
    ref.init(nchan, max_delay, f0, df, exponent, method=jax_method)
    port = Fdmt().init(nchan, max_delay, f0, df, exponent)
    return ref, port


def _assert_same_tables(ref, port):
    assert len(ref._steps) == len(port._steps)
    for a, b in zip(ref._steps, port._steps):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert len(ref._buckets) == len(port._buckets)
    for a, b in zip(ref._buckets, port._buckets):
        for k in ("start", "stop", "nrows", "max_delay"):
            assert a[k] == b[k], k
        for x, y in zip(a["tables"], b["tables"]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(ref._init_perm, port._init_perm)
    assert len(ref._init_chans_by_d) == len(port._init_chans_by_d)
    for x, y in zip(ref._init_chans_by_d, port._init_chans_by_d):
        np.testing.assert_array_equal(x, y)
    assert ref._init_ndelay == port._init_ndelay
    assert ref._final_ndelay == port._final_ndelay
    assert ref._reversed == port._reversed


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float32))
    return a.view(np.uint32)


@pytest.mark.parametrize("nchan,max_delay,f0,df,exponent", GEOMETRIES)
def test_plan_tables_identical(nchan, max_delay, f0, df, exponent):
    ref, port = _plans(nchan, max_delay, f0, df, exponent)
    _assert_same_tables(ref, port)
    rr, pr = ref.plan_report(), port.plan_report()
    for k in ("nsteps", "nbuckets", "bucket_steps", "bucket_nrows",
              "bucket_max_delay", "rowsteps_exact", "rowsteps_bucketed"):
        assert rr[k] == pr[k], k


def test_lwa_plan_shape():
    """The FRB-search geometry the chip run uses: 12 merge steps in 3
    buckets of 5696/3096/2176 rows, 2048 output rows."""
    port = Fdmt().init(4096, 2048, 40.0, 0.00928)
    rep = port.plan_report()
    assert rep["nsteps"] == 12
    assert rep["bucket_nrows"] == [5696, 3096, 2176]
    assert rep["bucket_steps"] == [2, 3, 7]
    assert port._init_depth == 2 and port._final_ndelay == 2048


def _inputs(nchan, ntime, seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 256, (nchan, ntime)).astype(np.float32)
    floats = rng.standard_normal((nchan, ntime)).astype(np.float32)
    floats[:, ::7] = -0.0     # the +0.0 of partner-less rows shows here
    return {"int": ints, "f32": floats}


@pytest.mark.parametrize("jax_method", ["pallas", "scan"])
@pytest.mark.parametrize("nchan,max_delay,f0,df,exponent,ntime",
                         EXEC_GEOMETRIES)
def test_execute_bitwise_vs_jax(nchan, max_delay, f0, df, exponent, ntime,
                                jax_method):
    ref, port = _plans(nchan, max_delay, f0, df, exponent, jax_method)
    for kind, x in _inputs(nchan, ntime, seed=nchan + ntime).items():
        for neg in (False, True):
            want = np.asarray(ref.execute(x, negative_delays=neg))
            got = port.execute(torch.from_numpy(x), negative_delays=neg)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                          err_msg=f"{kind} neg={neg}")


@pytest.mark.parametrize("nchan,max_delay,f0,df,exponent,ntime",
                         EXEC_GEOMETRIES[:4])
def test_execute_batched_and_integer_input(nchan, max_delay, f0, df,
                                           exponent, ntime):
    """3-D batched input and u8 input (lifted to f32) as JAX does."""
    ref, port = _plans(nchan, max_delay, f0, df, exponent)
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((3, nchan, ntime)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(port.execute(torch.from_numpy(xb)).numpy()),
        _bits(np.asarray(ref.execute(xb))))
    xu = rng.integers(0, 256, (nchan, ntime)).astype(np.uint8)
    np.testing.assert_array_equal(
        _bits(port.execute(torch.from_numpy(xu)).numpy()),
        _bits(np.asarray(ref.execute(xu))))


@pytest.mark.parametrize("nchan,max_delay,f0,df,exponent,ntime",
                         EXEC_GEOMETRIES)
def test_naive_bitwise_vs_jax_naive(nchan, max_delay, f0, df, exponent,
                                    ntime):
    ref, _ = _plans(nchan, max_delay, f0, df, exponent, "naive")
    port = Fdmt().init(nchan, max_delay, f0, df, exponent, method="naive")
    x = _inputs(nchan, ntime, seed=5)["f32"]
    np.testing.assert_array_equal(
        _bits(port.execute(torch.from_numpy(x)).numpy()),
        _bits(np.asarray(ref.execute(x))))


@pytest.mark.parametrize("method", ["cuda", "plain"])
def test_methods_agree_and_cpu_launches_nothing(method):
    """'cuda' on a CPU tensor takes the merge step's plain version (no
    kernel launch); 'plain' is the same arithmetic."""
    x = torch.from_numpy(_inputs(64, 160, seed=9)["f32"])
    base = Fdmt().init(64, 128, 60e6, 0.1e6, method="plain").execute(x)
    before = fdmt_kernel.merge_step.launches
    got = Fdmt().init(64, 128, 60e6, 0.1e6, method=method).execute(x)
    assert fdmt_kernel.merge_step.launches == before
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(base.numpy()))


@pytest.mark.parametrize("nchan,max_delay,f0,df,exponent,ntime",
                         EXEC_GEOMETRIES)
def test_plan_from_reference_round_trip(nchan, max_delay, f0, df, exponent,
                                        ntime):
    """Tables carried over from the JAX plan run identically to the
    port's own plan."""
    ref, port = _plans(nchan, max_delay, f0, df, exponent)
    carried = plan_from_reference(
        {k: getattr(ref, k) for k in ("_steps", "_buckets", "_init_perm",
                                      "_init_chans_by_d")},
        nchan, max_delay, f0, df, exponent)
    _assert_same_tables(port, carried)
    assert carried.plan_report()["rowsteps_bucketed"] == \
        port.plan_report()["rowsteps_bucketed"]
    x = torch.from_numpy(_inputs(nchan, ntime, seed=11)["f32"])
    for method in ("cuda", "naive"):
        carried.method = port.method = method
        np.testing.assert_array_equal(
            _bits(carried.execute(x).numpy()), _bits(port.execute(x).numpy()))
    port.method = "cuda"
    np.testing.assert_array_equal(
        _bits(plan_from_reference(port.tables(), nchan, max_delay, f0, df,
                                  exponent).execute(x).numpy()),
        _bits(port.execute(x).numpy()))


def test_merge_step_plain_semantics():
    """The plain merge step against a loop over its definition, including
    rows with no partner (+0.0 is added: -0.0 comes out +0.0) and delays
    past the row's length."""
    rng = np.random.default_rng(2)
    state = rng.standard_normal((12, 20)).astype(np.float32)
    state[3] = -0.0
    rowA = rng.integers(0, 12, 10).astype(np.int32)
    rowA[0] = 3
    rowB = rng.integers(-1, 12, 10).astype(np.int32)
    rowB[0] = -1
    delay = rng.integers(0, 25, 10).astype(np.int32)
    got = fdmt_kernel.merge_step(
        torch.from_numpy(state), torch.from_numpy(rowA),
        torch.from_numpy(rowB), torch.from_numpy(delay),
        out=torch.empty(10, 20)).numpy()
    want = np.empty((10, 20), np.float32)
    for r in range(10):
        for t in range(20):
            b = state[rowB[r], t - delay[r]] \
                if rowB[r] >= 0 and t >= delay[r] else np.float32(0.0)
            want[r, t] = state[rowA[r], t] + b
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.signbit(got[0]).any()



@pytest.mark.parametrize("method", ["cuda", "plain", "naive"])
@pytest.mark.parametrize("nchan,max_delay,f0,df,exponent,ntime",
                         EXEC_GEOMETRIES[:4] + EXEC_GEOMETRIES[5:])
def test_batched_equals_per_slice(nchan, max_delay, f0, df, exponent, ntime,
                                  method):
    """A (batch, nchan, ntime) block runs through every stage as one
    block (one merge-step call per step for the whole batch) and equals,
    bitwise, each slice dedispersed on its own, for both delay signs."""
    plan = Fdmt().init(nchan, max_delay, f0, df, exponent, method=method)
    rng = np.random.default_rng(nchan + ntime)
    xb = rng.standard_normal((3, nchan, ntime)).astype(np.float32)
    xb[:, :, ::7] = -0.0
    for neg in (False, True):
        got = plan.execute(torch.from_numpy(xb), negative_delays=neg)
        for i in range(3):
            want = plan.execute(torch.from_numpy(xb[i]), negative_delays=neg)
            np.testing.assert_array_equal(_bits(got[i].numpy()),
                                          _bits(want.numpy()))


def test_batched_one_call_per_step(monkeypatch):
    """The beam search's FDMT (4096 channels from 40 MHz in steps of
    1 / (4096 x 1 us), max_delay 64, 65 samples a row) over 8 beams makes
    one merge-step call per step for all beams, and equals JAX
    `Fdmt.execute` on the same batch bitwise."""
    import bifrost_tpu_torch.ops.fdmt as port_fdmt
    calls = []

    def step(state, rowA, rowB, delay, out):
        calls.append(state.shape[0])
        return fdmt_kernel.merge_step(state, rowA, rowB, delay, out=out)

    monkeypatch.setattr(port_fdmt, "merge_step", step)
    geo = (4096, 64, 40.0, 1e-6 / (1e-6 * 4096))
    ref, port = _plans(*geo, -2.0)
    rng = np.random.default_rng(21)
    xb = rng.integers(0, 64, (8, 4096, 65)).astype(np.float32)
    got = port.execute(torch.from_numpy(xb))
    assert calls == [8] * len(port._steps) and len(calls) == 12
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(np.asarray(ref.execute(xb))))
