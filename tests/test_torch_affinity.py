"""Core affinity of block threads on the CPU, the port against the JAX
package: affinity.get_core/set_core/set_openmp_cores and their messages,
`block_scope(core=)` pinning a block's thread (read inside it and from its
bind proclog), `share_temp_storage`, `Ring(core=)`, TempStorage and the
interop round trips.  Pinning runs in threads of their own: the test
process's main thread is never pinned."""

import os
import threading

import numpy as np
import pytest
import torch

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import affinity, interop, proclog
from bifrost_tpu_torch.blocks import array_source, callback_sink
from bifrost_tpu_torch.temp_storage import TempStorage

import bifrost_tpu as jbt
from bifrost_tpu import affinity as jaffinity
from bifrost_tpu import blocks as jblocks

CORES = sorted(os.sched_getaffinity(0))


def _in_thread(fn):
    """fn() on a fresh thread; -> its result (or raise its exception)."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["exc"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    if "exc" in out:
        raise out["exc"]
    return out["value"]


@pytest.mark.parametrize("mod", [affinity, jaffinity],
                         ids=["torch", "jax"])
def test_set_core_pins_the_calling_thread(mod):
    core = CORES[-1]

    def pin():
        before = mod.get_core()
        mod.set_core(core)
        return before, mod.get_core()
    before, after = _in_thread(pin)
    assert after == core
    assert before == (CORES[0] if len(CORES) == 1 else -1)
    assert _in_thread(mod.get_core) == (CORES[0] if len(CORES) == 1
                                        else -1)


def test_set_openmp_cores_pins_to_the_first_core():
    for mod in (affinity, jaffinity):
        got = _in_thread(lambda: (mod.set_openmp_cores(CORES[::-1]),
                                  mod.get_core())[1])
        assert got == CORES[-1]
        assert _in_thread(lambda: (mod.set_openmp_cores([]),
                                   mod.get_core())[1]) == \
            (CORES[0] if len(CORES) == 1 else -1)


@pytest.mark.parametrize("core", [10 ** 6, 1 << 16])
def test_set_core_out_of_range_raises_the_jax_message(core):
    msgs = []
    for mod in (affinity, jaffinity):
        with pytest.raises(ValueError) as e:
            _in_thread(lambda: mod.set_core(core))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert f"cannot pin thread to core {core}" in msgs[0]


def test_thread_is_named_for_its_block():
    seen = []
    with bt.Pipeline(device="cpu") as pipe:
        callback_sink(array_source(np.zeros((8, 2), np.float32), 4),
                      on_data=lambda d: seen.append(
                          open(f"/proc/self/task/{threading.get_native_id()}"
                               "/comm").read().strip()),
                      name="named_sink_block_long")
        pipe.run()
    assert seen and seen[0] == "named_sink_bloc"


def _port_pinned(core):
    seen = []
    with bt.Pipeline(device="cpu") as pipe:
        src = array_source(np.arange(32, dtype=np.float32).reshape(16, 2), 4)
        with bt.block_scope(core=core):
            snk = callback_sink(src, on_data=lambda d: seen.append(
                affinity.get_core()))
        pipe.run()
        tree = proclog.load_by_pid(os.getpid())
    return seen, tree[snk.name]["bind"], tree[src.name]["bind"], snk


def _jax_pinned(core):
    from bifrost_tpu import proclog as jproclog
    from bifrost_tpu.pipeline import Pipeline
    seen = []
    with Pipeline() as pipe:
        src = jblocks.array_source(
            np.arange(32, dtype=np.float32).reshape(16, 2), 4)
        with jbt.block_scope(core=core):
            snk = jblocks.callback_sink(src, on_data=lambda d: seen.append(
                jaffinity.get_core()))
        pipe.run()
        tree = jproclog.load_by_pid(os.getpid())
    return seen, tree[snk.name]["bind"], tree[src.name]["bind"]


def test_block_scope_core_pins_the_block_thread_as_jax_does():
    """`block_scope(core=N)` pins the block's thread to N (read inside
    it), its bind proclog records N, an unscoped block records -1, as the
    JAX pipeline does for the same scope; the block's output ring records
    the core too."""
    core = CORES[len(CORES) // 2]
    seen, bind, src_bind, snk = _port_pinned(core)
    jseen, jbind, jsrc_bind = _jax_pinned(core)
    assert seen and set(seen) == {core} and set(jseen) == {core}
    assert bind["core"] == jbind["core"] == core
    assert src_bind["core"] == jsrc_bind["core"] == -1


def test_ring_records_its_blocks_core():
    with bt.Pipeline(device="cpu"):
        with bt.block_scope(core=CORES[0]):
            src = array_source(np.zeros((4, 2), np.float32), 2)
        plain = array_source(np.zeros((4, 2), np.float32), 2)
    assert src.orings[0].core == CORES[0]
    assert plain.orings[0].core is None
    assert bt.Ring(space="system", core=3).core == 3


def test_nested_scopes_resolve_the_innermost_core():
    with bt.Pipeline(device="cpu"):
        with bt.block_scope(core=CORES[0]):
            with bt.block_scope(gulp_nframe=2):
                a = array_source(np.zeros((4, 2), np.float32), 2)
            with bt.block_scope(core=CORES[-1]):
                b = array_source(np.zeros((4, 2), np.float32), 2)
    assert a.core == CORES[0] and b.core == CORES[-1]


def test_share_temp_storage_is_accepted():
    with bt.Pipeline(device="cpu"):
        with bt.block_scope(share_temp_storage=True) as scope:
            blk = array_source(np.zeros((4, 2), np.float32), 2)
    assert scope.share_temp_storage is True and blk.share_temp_storage
    with pytest.raises(TypeError, match="unexpected scope setting"):
        bt.block_scope(cores=1)


def test_temp_storage_grows_and_locks_as_the_jax_one():
    from bifrost_tpu.temp_storage import TempStorage as JaxTempStorage
    for ts in (TempStorage(), JaxTempStorage()):
        with ts.allocate(100) as a:
            assert len(a.data) == 100
            assert not ts.lock.acquire(blocking=False)
        with ts.allocate(40) as b:
            assert len(b.data) == 40 and ts.size == 100
        with ts.allocate(300):
            assert ts.size == 300
        assert ts.lock.acquire(blocking=False)
        ts.lock.release()
    port = TempStorage()
    with port.allocate(8) as a:
        assert isinstance(a.data, torch.Tensor)
        assert a.data.dtype == torch.uint8 and a.data.device.type == "cpu"
    assert TempStorage("cuda", device="cpu").device.type == "cpu"


def test_interop_torch_roundtrip():
    """tests/test_dtype.py's interop case on the port."""
    a = np.random.rand(4, 3).astype(np.float32)
    t = interop.as_torch(a)
    assert t.shape == (4, 3)
    back = interop.from_torch(t)
    np.testing.assert_array_equal(np.asarray(back), a)
    raw = np.zeros(6, dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = np.arange(6)
    tc = interop.as_torch(raw)
    assert tuple(tc.shape) == (6, 2)
    assert tc[:, 0].tolist() == list(range(6))


def test_interop_is_zero_copy_and_typed():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = interop.as_torch(a)
    assert t.data_ptr() == a.ctypes.data
    assert interop.from_torch(t).data_ptr() == t.data_ptr()
    assert np.shares_memory(interop.as_numpy(t), a)
    z = torch.tensor([1.4 + 2.6j, -3.5 - 0.2j], dtype=torch.complex64)
    st = interop.from_torch(z, dtype="ci16")
    assert st.dtype == torch.int16 and st.tolist() == [[1, 3], [-4, 0]]
    assert interop.from_torch(t, dtype="f64").dtype == torch.float64
    src = torch.arange(5)

    class Producer:                     # a DLPack producer, not numpy
        def __dlpack__(self, **kw):
            return src.__dlpack__(**kw)

        def __dlpack_device__(self):
            return src.__dlpack_device__()
    taken = interop.as_torch(Producer())
    assert taken.data_ptr() == src.data_ptr() and torch.equal(taken, src)
    assert interop.as_numpy(Producer()).tolist() == list(range(5))
