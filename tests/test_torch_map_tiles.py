"""M1's eager explicit-index form on its three paths, on the CPU: the
tile path (a shared-memory corner turn for reads whose contiguous axis
is not the output's innermost), the vector path (affine reads stepping
forward or backward along the innermost axis) and the element path, and
the injective affine scatter run as one pass over its target.

The generated bodies are compiled by the host C++ compiler
(`map_kernel.map_apply_host`: the tile's load and store phases run over
a host array standing for the shared memory, thread after thread) and
held bitwise to the plain engine (the eager `map` with 'plain', M1's
plain version of an eager call) and to the JAX package's eager `map` on the same seeded
numpy input.  The paths and launches each launch takes are asserted:
they follow from the program and the operands' shapes, strides and
scalars alone.  Kernel M1 itself is held to its plain version on the
card by tests/test_torch_gpu.py and chip_smoke's [map].
"""

import numpy as np
import pytest
import torch

from bifrost_tpu.ops.map import map as j_map

from bifrost_tpu_torch import config
from bifrost_tpu_torch.ops import map_kernel
from bifrost_tpu_torch.ops.map import map as eager_map
from torch_map_forms import eager_program

DTYPES = {"f32": np.float32, "c64": np.complex64, "i8": np.int8,
          "f16": np.float16, "i32": np.int32}


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    config.reset("map_method")


def _array(shape, dt, seed):
    """Seeded numpy values of type `dt` (small integers for the integer
    types, so that sums stay exact)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-40, 40, shape) if np.dtype(dt).kind in "iu" else \
        rng.standard_normal(shape) * 3
    if np.dtype(dt).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return np.asarray(x).astype(dt)


def _bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.tobytes() == b.tobytes()


def _run(func, data, axes, shape, views=None):
    """The eager call's program on the host-compiled body against the
    plain engine and the JAX package on the same arrays -> (host outputs
    as numpy, the launch's plan, launches).  `views` maps a name to a
    function making the tensor the kernel reads (a strided or transposed
    view) from its numpy array; the plain engine and JAX read the same
    values."""
    tens = {k: torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
            else v for k, v in data.items()}
    for k, fn in (views or {}).items():
        tens[k] = fn(tens[k])
    vals = {k: (np.ascontiguousarray(v.numpy()) if isinstance(v, torch.Tensor)
                else v) for k, v in tens.items()}
    prog, ins, outs = eager_program(func, tens, axes, shape)
    before = map_kernel.map_apply_host.launches
    host, _ = map_kernel.map_apply_host(
        prog, ins, shape, [tens[k] for k in prog.scalar_names])
    launches = map_kernel.map_apply_host.launches - before
    plan = dict(map_kernel.map_apply_host.last)
    config.set("map_method", "plain")
    plain = eager_map(func, {k: (v.clone() if isinstance(v, torch.Tensor)
                                 else v) for k, v in tens.items()},
                      axis_names=axes, shape=shape)
    config.reset("map_method")
    jax = j_map(func, dict(vals), axis_names=axes, shape=shape)
    if not isinstance(plain, dict):
        plain, jax = {outs[0]: plain}, {outs[0]: jax}
    got = {o: h.numpy() for o, h in zip(outs, host)}
    assert set(got) == set(plain) == set(jax)
    for o in outs:
        assert _bits(got[o], plain[o].numpy()), o
        assert _bits(got[o], np.asarray(jax[o])), o
    return got, plan, launches


# (id, program, arrays: name -> (shape, seed), grid, the path, launches)
GATHERS = [
    ("transpose 37x45", "c(i,j) = a(j,i)", {"a": ((45, 37), 1)}, (37, 45),
     "tile", 1),
    ("transpose 1xn", "c(i,j) = a(j,i)", {"a": ((45, 1), 2)}, (1, 45),
     "element", 1),
    ("transpose nx1", "c(i,j) = a(j,i)", {"a": ((1, 45), 3)}, (45, 1),
     "element", 1),
    ("permutation 3-d", "c(i,j,k) = a(k,i,j)", {"a": ((9, 6, 35), 4)},
     (6, 35, 9), "tile", 1),
    ("reversed inner", "c(i,j) = a(i, nj-1-j)", {"a": ((13, 40), 5)},
     (13, 40), "vector", 1),
    ("reversed outer", "c(i,j) = a(ni-1-i, j)", {"a": ((13, 40), 6)},
     (13, 40), "vector", 1),
    ("reversed ragged", "c(i,j) = a(ni-1-i, nj-1-j)", {"a": ((13, 39), 7)},
     (13, 39), "element", 1),
    ("turned and reversed", "c(i,j) = a(nj-1-j, i) * 2",
     {"a": ((40, 33), 8)}, (33, 40), "tile", 1),
    ("flip", "c(i, nj-1-j) = a(i, j)", {"a": ((12, 40), 9),
                                        "c": ((12, 40), 10)}, (12, 40),
     "vector", 1),
    ("flip outer", "c(ni-1-i, j) = a(i, j)", {"a": ((12, 40), 11),
                                              "c": ((12, 40), 12)},
     (12, 40), "vector", 1),
    ("transpose as scatter", "c(j,i) = a(i,j)",
     {"a": ((37, 45), 13), "c": ((45, 37), 14)}, (37, 45), "tile", 1),
]


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", GATHERS, ids=[c[0] for c in GATHERS])
def test_paths_bitwise(case, dt):
    """Transposes at ragged shapes, a 3-D permutation, reads reversed on
    the inner and the outer axis, the band flip and the transpose written
    as scatters (one launch over the target): each on the path its
    strides give, bitwise the plain engine and JAX.  A vector item holds
    V samples (16 bytes of the widest type: 16 int8, 2 complex64), so an
    innermost extent V does not divide takes the element path."""
    _, func, arrays, grid, path, launches = case
    data = {k: _array(s, DTYPES[dt], seed) for k, (s, seed) in
            arrays.items()}
    _, plan, n = _run(func, data, ("i", "j", "k")[:len(grid)], grid)
    if path == "vector" and grid[-1] % (16 // np.dtype(DTYPES[dt]).itemsize):
        path = "element"
    assert (plan["path"], n) == (path, launches), plan


def test_offset_read_inside_and_outside():
    """``a(i, j + k)``: inside its input the read is affine, on the
    vector path where its vector access is aligned (k a multiple of V)
    and the element path otherwise; where k takes it outside, the
    element path clamps it as jnp does (the plan says why)."""
    a = _array((10, 48), np.float32, 20)
    for k, shape, path in ((8, (10, 40), "vector"), (3, (10, 40), "element"),
                           (9, (10, 40), "element")):
        _, plan, n = _run("c(i,j) = a(i, j + k)", {"a": a, "k": k},
                          ("i", "j"), shape)
        assert (plan["path"], n) == (path, 1), (k, plan)
        assert (plan["note"] is None) == (k <= 8), plan


@pytest.mark.parametrize("view,path", [
    ("strided", "tile"), ("transposed", "vector"), ("sliced", "tile")])
def test_input_views(view, path):
    """The read's steps are its input's strides: a strided view keeps the
    turn (its smallest step 2), a transposed view makes the transpose a
    forward read (the vector path), an offset slice is read in place."""
    base = _array((36, 96), np.complex64, 21)
    fn = {"strided": lambda t: t[:, ::2],
          "transposed": lambda t: t.t()[:48],
          "sliced": lambda t: t[3:35, 5:53]}[view]
    shape = tuple(fn(torch.from_numpy(base)).shape)
    _, plan, n = _run("c(i,j) = a(j,i) * 3", {"a": base}, ("i", "j"),
                      shape[::-1], views={"a": fn})
    assert (plan["path"], n) == (path, 1), plan


def test_two_turned_reads_must_agree():
    """Turned reads whose contiguous axes differ cannot share one tile:
    the element path, the plan naming the axes."""
    a = _array((9, 6, 35), np.float32, 22)
    b = _array((35, 9, 6), np.float32, 23)
    _, plan, _ = _run("c(i,j,k) = a(k,i,j) + b(j,k,i)", {"a": a, "b": b},
                      ("i", "j", "k"), (6, 35, 9))
    assert plan["path"] == "element" and "disagree" in plan["note"], plan


def test_injective_scatter_not_onto():
    """``c(i + 1, j) = a(i, j)`` over a grid one row short of the target:
    one launch over the target, its row 0 (no source) keeps the target's
    values; over the whole target the last source row falls outside (a
    drop) and the scatter takes its two passes."""
    a = _array((12, 40), np.float32, 24)
    c = _array((12, 40), np.float32, 25)
    got, plan, n = _run("c(i + 1, j) = a(i, j)", {"a": a[:11], "c": c},
                        ("i", "j"), (11, 40))
    assert (n, plan["scatter"], plan["path"]) == (1, "one-pass", "element")
    assert _bits(got["c"][0], c[0]) and _bits(got["c"][1:], a[:11])
    got, plan, n = _run("c(j + 1, i) = a(i, j)", {"a": a, "c": c[:, :13]},
                        ("i", "j"), (12, 11))
    assert (n, plan["path"]) == (1, "tile"), plan
    assert _bits(got["c"][0], c[0, :13])
    _, plan, n = _run("c(i + 1, j) = a(i, j)", {"a": a, "c": c},
                      ("i", "j"), (12, 40))
    assert (n, plan["scatter"]) == (2, "two-pass"), plan


# (program, scalars, grid, the target's shape, launches): the scatter's
# rule.
SCATTERS = [
    ("c(j, i) = a(i, j)", {}, (12, 10), (10, 12), 1),
    ("c(i, nj-1-j) = a(i, j)", {}, (10, 12), (10, 12), 1),
    ("c(nj-1-j, ni-1-i) = a(i, j) * 2", {}, (12, 10), (10, 12), 1),
    ("c(i + k, j) = a(i, j)", {"k": 1}, (9, 12), (10, 12), 1),
    ("c(i + k, j) = a(i, j)", {"k": 2}, (9, 12), (10, 12), 2),   # a drop
    ("c(i - 1, j) = a(i, j)", {}, (10, 12), (10, 12), 2),        # a wrap
    ("c(i // 2, j) = a(i, j)", {}, (10, 12), (10, 12), 2),       # repeated
    ("c(2 * i - i, j) = a(i, j)", {}, (10, 12), (10, 12), 2),    # not affine
    ("c(j + i - i, i) = a(i, j)", {}, (10, 10), (10, 10), 2),  # two axes
    ("d(i, j) = a(i, j) * 2; c(j, i) = a(i, j)", {}, (10, 10), (10, 10),
     2),                                             # another output
]


@pytest.mark.parametrize("func,scalars,grid,target,launches", SCATTERS)
def test_scatter_launches(func, scalars, grid, target, launches):
    """One launch for a scatter whose indices are a permutation of the
    grid axes, each ``+-axis + offset``, found inside the target at this
    launch and the program's only output; two (the owner words, then the
    writes) for a drop, a wrap, repeated targets, an index that is not
    affine, and a program with another output.  Bitwise either way."""
    data = {"a": _array(grid, np.float32, 26),
            "c": _array(target, np.float32, 27)}
    data.update(scalars)
    _, plan, n = _run(func, data, ("i", "j"), grid)
    assert n == launches, plan
    assert plan["scatter"] == ("one-pass" if launches == 1 else "two-pass")


@pytest.mark.parametrize("func,arrays,grid,path", [
    ("c(i,j) = a(j,i)", {"a": (44, 39)}, (39, 44), "tile"),
    ("c(i,j) = a(i, nj-1-j)", {"a": (14, 40)}, (14, 40), "vector"),
    ("c(i, nj-1-j) = a(i, j)", {"a": (11, 40), "c": (11, 40)}, (11, 40),
     "vector"),
    ("c(j,i) = a(i,j)", {"a": (39, 44), "c": (44, 39)}, (39, 44), "tile"),
])
def test_index64_form_bitwise(func, arrays, grid, path, monkeypatch):
    """The 64-bit index type (map_kernel.INDEX32_LIMIT lowered to 16) on
    the tile, vector and one-pass paths, bitwise (shapes of their own: a
    program keeps the words of the layouts it has seen)."""
    monkeypatch.setattr(map_kernel, "INDEX32_LIMIT", 16)
    data = {k: _array(s, np.complex64, 30 + n)
            for n, (k, s) in enumerate(arrays.items())}
    _, plan, n = _run(func, data, ("i", "j"), grid)
    assert (plan["index"], plan["path"], n) == ("int64", path, 1), plan


def test_program_geometry():
    """What the generator decides from the program: V for the gather
    form (16 bytes of its widest operand), each affine read and the
    one-pass scatter's components, and the tile by element size."""
    from bifrost_tpu_torch.ops import map_codegen
    x = torch.zeros(4, 6, dtype=torch.complex64)
    prog = eager_program("c(i,j) = a(j,i) + a(i, nj-1-j) * a(i//2, j)",
                         {"a": x}, ("i", "j"), (4, 6))[0]
    assert prog.vec == 2 and len(prog.sites) == 2
    assert [[(s, ax) for s, ax, _ in c] for _, c in prog.sites] == \
        [[(1, 1), (1, 0)], [(1, 0), (-1, 1)]]
    assert prog.tile[:2] == map_codegen.TILES[8] == (32, 32)
    prog = eager_program("c(nj-1-j, i) = a(i, j)", {
        "a": torch.zeros(4, 6, dtype=torch.int8),
        "c": torch.zeros(6, 4, dtype=torch.int8)}, ("i", "j"), (4, 6))[0]
    assert prog.vec == 16 and prog.tile[:2] == (64, 64)
    assert [(s, ax) for s, ax, _ in prog.one_pass[1]] == [(-1, 1), (1, 0)]
