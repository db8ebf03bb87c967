"""The port's public names hold to the JAX package's.

For every module of `bifrost_tpu` that has a namesake in
`bifrost_tpu_torch` (the same path under the package), every public name
the JAX module defines at its top level (a function, a class, a
constant) must resolve in the port's module, and every public method of
a class both define must resolve on the port's class (as a class
attribute, or as an attribute its `__init__` sets).  Every name of the
JAX package's top level (bifrost_tpu/__init__.py:20-68) must resolve on
`bifrost_tpu_torch`.  The only exceptions are the JAX- and TPU-bound
names of `NOT_PORTED`, each with its reason and the port's counterpart;
ROADMAP.md's "Not to port" lists the same names.  A JAX-side name the
port lacks fails here, not in a user's script."""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "bifrost_tpu"
PORT_PKG = ROOT / "bifrost_tpu_torch"

# (module path under the package, "" for the top level; name, or
# Class.method) -> (why it is not ported, the port's counterpart).
NOT_PORTED = {
    ("", "to_jax"): (
        "moves a host array onto a JAX device",
        "asarray(x, space='cuda')"),
    ("", "from_jax"): (
        "reads a jax.Array back to the host",
        "asarray(t, space='system')"),
    ("ndarray", "to_jax"): (
        "moves a host array onto a JAX device",
        "ndarray.asarray(x, space='cuda')"),
    ("ndarray", "from_jax"): (
        "reads a jax.Array back to the host",
        "ndarray.asarray(t, space='system'), copy_array"),
    ("ndarray", "ndarray.as_jax"): (
        "a host array's transfer into JAX",
        "ndarray.asarray(a, space='cuda')"),
    ("interop", "as_jax"): (
        "the bridge into JAX; the port imports no JAX",
        "interop.as_torch, interop.from_torch (DLPack)"),
    ("device", "donating_jit"): (
        "jax.jit with buffer donation",
        "none needed: eager PyTorch, whose caching allocator reuses "
        "the buffers"),
    ("core", "tpu_enabled"): (
        "probes for a TPU",
        "core.cuda_enabled"),
    ("ops.common", "complexify"): (
        "the jitted (re, im) -> complex lift of a jax.Array",
        "ndarray.complex_view"),
    ("ops.common", "decomplexify"): (
        "the jitted complex -> (re, im) lowering of a jax.Array",
        "ndarray.storage_view"),
    ("ops.stats", "median_mad_jnp"): (
        "the jnp twin of the numpy statistic",
        "ops.stats.median_mad on tensors"),
    ("ops.stats", "mad_snr_jnp"): (
        "the jnp twin of the numpy statistic",
        "ops.stats.mad_snr on tensors"),
    ("ops.stats", "spectral_kurtosis_jnp"): (
        "the jnp twin of the numpy statistic",
        "ops.stats.spectral_kurtosis on tensors"),
    ("ops.fft", "Fft.traceable"): (
        "the raw transform traced into a fused jax.jit program",
        "Fft.execute, which a fused group's FFT stage calls"),
    ("ops.fir", "Fir.use_pallas"): (
        "selects the Pallas TPU kernel",
        "Fir.method and the fir_method flag ('cuda' runs K2)"),
    ("ops.calibrate", "GainCal.stage_fn"): (
        "the jitted executor a fused JAX program threads",
        "GainCal.execute, GainCal.execute_raw"),
    ("ops.flag", "Flag.stage_fn"): (
        "the jitted executor a fused JAX program threads",
        "Flag.step, Flag.step_raw"),
    ("ops.flag", "Flag.staged_params"): (
        "device parameters threaded as a jit argument",
        "Flag.set_params (the plan holds its parameters)"),
    ("ops.pfb", "Pfb.stage_fn"): (
        "the jitted executor a fused JAX program threads",
        "Pfb.step, Pfb.step_raw"),
    ("ops.pfb", "Pfb.staged_bank"): (
        "the folded bank threaded as a jit argument",
        "Pfb.staged(device)"),
    ("ring", "u64"): (
        "the ctypes type of the JAX C ring engine's counters",
        "none: the port's ring engine is Python (ROADMAP Queue A "
        "item 10)"),
    ("ring", "MISALIGNED"): (
        "marks a misaligned read of the JAX ring's store of jax.Arrays "
        "beside its bytes",
        "none: a 'cuda' ring keeps its bytes on the card"),
    ("ring", "TensorInfo.jax_shape"): (
        "the storage shape of a jax.Array gulp",
        "TensorInfo.span_shape"),
    ("ring", "TensorInfo.logical_jax_shape"): (
        "the logical shape of a jax.Array gulp",
        "TensorInfo.host_span_shape"),
    ("ring", "TensorInfo.jax_zeros"): (
        "jitted zeros of a jax.Array gulp",
        "torch.zeros(TensorInfo.span_shape(nframe))"),
    ("pipeline", "SequenceView.obj"): (
        "the JAX C engine's sequence handle",
        "SequenceView.base"),
}


def _module_path(path, root):
    rel = path.relative_to(root).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _namesakes():
    """JAX module paths with a port file at the same place."""
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        if "lib" in path.relative_to(JAX_PKG).parts[:1]:
            continue
        if (PORT_PKG / path.relative_to(JAX_PKG)).exists():
            out.append(_module_path(path, JAX_PKG))
    return out


def _defined(mod):
    """-> (public top-level names, {public class: [public methods]}) that
    the JAX module's source defines."""
    rel = Path(*mod.split(".")) if mod else Path()
    path = JAX_PKG / rel / "__init__.py"
    if not path.exists():
        path = JAX_PKG / rel.with_suffix(".py")
    tree = ast.parse(path.read_text())
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            classes[node.name] = sorted({
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")})
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    names = sorted(n for n in names if not n.startswith("_"))
    return names, {c: m for c, m in classes.items()
                   if not c.startswith("_")}


def _instance_attrs(cls):
    """Attributes the port class (and its port bases) set on `self`."""
    attrs = set()
    for klass in cls.__mro__:
        if not klass.__module__.startswith("bifrost_tpu_torch"):
            continue
        tree = ast.parse(inspect.cleandoc("\n" + inspect.getsource(klass)))
        for node in ast.walk(tree):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target] if isinstance(node, ast.AnnAssign) else []
            for t in targets:
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and t.value.id == "self":
                    attrs.add(t.attr)
    return attrs


def _port_module(mod):
    return importlib.import_module(
        "bifrost_tpu_torch" + (f".{mod}" if mod else ""))


MODULES = _namesakes()


def test_the_walk_finds_the_modules():
    for mod in ("", "memory", "ndarray", "device", "block", "pipeline",
                "ring", "ops.fft", "ops.runtime", "egress", "config"):
        assert mod in MODULES, mod


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m or "__init__")
def test_every_public_name_resolves(mod):
    port = _port_module(mod)
    names, classes = _defined(mod)
    missing = [n for n in names
               if (mod, n) not in NOT_PORTED and not hasattr(port, n)]
    for cname, methods in classes.items():
        pcls = getattr(port, cname, None)
        if pcls is None or not inspect.isclass(pcls):
            continue
        attrs = None
        for m in methods:
            if (mod, f"{cname}.{m}") in NOT_PORTED or hasattr(pcls, m):
                continue
            if attrs is None:
                attrs = _instance_attrs(pcls)
            if m not in attrs:
                missing.append(f"{cname}.{m}")
    assert not missing, f"bifrost_tpu_torch.{mod} lacks {missing}"


def _jax_top_level_names():
    """Every name bifrost_tpu/__init__.py gives: its eager imports, its
    lazy modules and the names its __getattr__ resolves."""
    tree = ast.parse((JAX_PKG / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_LAZY"
                for t in node.targets):
            names.update(k.value for k in node.value.keys)
        elif isinstance(node, ast.FunctionDef) and \
                node.name == "__getattr__":
            for cmp in ast.walk(node):
                if isinstance(cmp, ast.Compare) and \
                        isinstance(cmp.comparators[0], ast.Constant):
                    names.add(cmp.comparators[0].value)
    names.discard("annotations")
    return sorted(names)


@pytest.mark.parametrize("name", _jax_top_level_names())
def test_every_top_level_name_resolves(name):
    import bifrost_tpu_torch as bf
    if ("", name) in NOT_PORTED:
        assert not hasattr(bf, name)
        return
    assert hasattr(bf, name), name


def test_top_level_names_mean_what_they_mean_in_jax():
    import types
    import bifrost_tpu as jbf
    import bifrost_tpu_torch as bf
    for name in _jax_top_level_names():
        if ("", name) in NOT_PORTED:
            continue
        jv, pv = getattr(jbf, name), getattr(bf, name)
        assert isinstance(pv, types.ModuleType) == \
            isinstance(jv, types.ModuleType), name
        assert inspect.isclass(pv) == inspect.isclass(jv), name
    assert bf.__version__ == jbf.__version__
    assert bf.core_version() == jbf.core_version()


@pytest.mark.parametrize("key", sorted(NOT_PORTED),
                         ids=lambda k: f"{k[0] or '__init__'}:{k[1]}")
def test_each_exception_is_a_jax_name_the_port_lacks(key):
    """An entry of NOT_PORTED names a JAX name the port does not have,
    with a reason and a counterpart; a name the port gains leaves it."""
    mod, name = key
    reason, counterpart = NOT_PORTED[key]
    assert reason and counterpart
    jax_mod = importlib.import_module(
        "bifrost_tpu" + (f".{mod}" if mod else ""))
    port = _port_module(mod)
    obj, pobj = jax_mod, port
    for part in name.split("."):
        assert hasattr(obj, part), (mod, name)
        obj = getattr(obj, part)
        pobj = getattr(pobj, part, None)
    assert pobj is None, f"{mod}:{name} is ported; drop it from NOT_PORTED"


def test_roadmap_lists_the_same_exceptions():
    text = (ROOT / "ROADMAP.md").read_text()
    section = text[text.index("**Not to port:**"):]
    section = section[:section.index("### Queue B")]
    for mod, name in NOT_PORTED:
        assert f"`{name}`" in section or f"`{mod}.{name}`" in section, \
            (mod, name)
