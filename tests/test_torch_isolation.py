"""The port stands alone: it imports neither JAX nor the JAX package (nor
loads its native library), its CUDA and host C++ sources include nothing
of it, its harness (benchmarks_torch/) imports neither, and its entry
points refuse to run without a card unless asked for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "bifrost_tpu_torch"


def test_import_leaves_jax_and_reference_out():
    # Every module of the package, imported in a fresh interpreter.
    code = ("import importlib, pkgutil, sys, bifrost_tpu_torch\n"
            "for m in pkgutil.walk_packages(bifrost_tpu_torch.__path__, "
            "'bifrost_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'bifrost_tpu' or "
            "m.startswith('bifrost_tpu.')]\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py", ROOT / "romein_bounds.py",
                          ROOT / "kernel_variants.py", ROOT / "chain_ab.py",
                          ROOT / "capture_slots.py"] +
                         sorted((ROOT / "benchmarks_torch").glob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "bifrost_tpu"), (path, mod)
    assert "libbifrost_tpu" not in path.read_text(), path


@pytest.mark.parametrize("path", sorted((PKG / "csrc").glob("*.cu")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_cuda_sources_include_nothing_of_the_reference(path):
    """A kernel source names the TPU kernel it replaces in a comment, and
    includes only CUDA's and the C++ library's headers."""
    text = path.read_text()
    assert "libbifrost_tpu" not in text, path
    for line in text.splitlines():
        if line.lstrip().startswith("#include"):
            assert "jax" not in line and "bifrost" not in line, line
            assert line.split()[1][0] == "<", line


@pytest.mark.parametrize("path", sorted((PKG / "csrc").glob("*.cpp")) +
                         sorted((PKG / "csrc").glob("*.h")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_host_sources_include_nothing_of_the_reference(path):
    """The UDP data plane's C++ sources are the port's own copies: they
    include system headers and the port's own header beside them, nothing
    of cpp/, and name no symbol of the JAX package's library."""
    text = path.read_text()
    assert "libbifrost_tpu" not in text, path
    for line in text.splitlines():
        if line.lstrip().startswith("#include"):
            inc = line.split()[1]
            assert "bifrost" not in inc and "jax" not in inc, line
            assert "btcore" not in inc and "internal.hpp" not in inc, line
            if inc[0] == '"':
                assert (PKG / "csrc" / inc.strip('"')).exists(), line
            else:
                assert inc[0] == "<", line
    for sym in ("btRing", "btSocket", "btUdp", "btProcLog"):
        assert sym not in text, (path, sym)


def test_pipeline_without_device_needs_a_card(monkeypatch):
    from bifrost_tpu_torch import Pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline()
    assert Pipeline(device="cpu").device == torch.device("cpu")
