"""bifrost_tpu_torch: the PyTorch and CUDA port of bifrost_tpu, for NVIDIA
Hopper.  It mirrors the JAX package's module names and imports nothing
of it (nor JAX).  Entry points run on the card unless the caller passes
``device='cpu'``.

Every name below is imported at first use, as the JAX package's
``__init__`` imports its higher layers: ``import bifrost_tpu_torch`` loads
neither torch nor a block, so the observability tools (``python -m
bifrost_tpu_torch.tools.like_top``), which read only the proclog tree,
start at once beside a running pipeline.  The names are the JAX
package's (bifrost_tpu/__init__.py:20-68) but for its JAX bridges
(`to_jax`, `from_jax`): `asarray` and `interop` are the port's."""

import importlib
import sys
import types

__version__ = "0.1.0"

_SUBMODULES = ("affinity", "block", "blocks", "block_chainer", "cache",
               "config", "core", "device", "egress", "faultinject", "fleet",
               "fuse", "interop", "io", "memory", "ops",
               "parallel", "pipeline", "portaudio", "proclog", "ring",
               "service", "shmring", "supervise", "telemetry",
               "temp_storage", "tools", "trace", "udp", "units", "views")
# Attribute -> a module of the port (bifrost_tpu/__init__.py:30-68).
_MODULE_ALIASES = {"map": ".ops.map", "fft": ".ops.fft", "fdmt": ".ops.fdmt",
                   "fir": ".ops.fir", "linalg": ".ops.linalg",
                   "reduce": ".ops.reduce", "transpose": ".ops.transpose",
                   "quantize": ".ops.quantize", "unpack": ".ops.unpack",
                   "romein": ".ops.romein", "sigproc": ".io.sigproc",
                   "guppi_raw": ".io.guppi_raw",
                   "header_standard": ".io.header_standard"}
# Attribute -> (module, its name there).
_ATTRS = {"BlockChainer": (".block_chainer", "BlockChainer"),
          "Block": (".pipeline", "Block"),
          "BlockScope": (".pipeline", "BlockScope"),
          "MultiTransformBlock": (".pipeline", "MultiTransformBlock"),
          "Pipeline": (".pipeline", "Pipeline"),
          "SinkBlock": (".pipeline", "SinkBlock"),
          "SourceBlock": (".pipeline", "SourceBlock"),
          "TransformBlock": (".pipeline", "TransformBlock"),
          "block_scope": (".pipeline", "block_scope"),
          "get_default_pipeline": (".pipeline", "get_default_pipeline"),
          "EndOfDataStop": (".ring", "EndOfDataStop"),
          "Ring": (".ring", "Ring"),
          "RingInterrupted": (".ring", "RingInterrupted"),
          "BifrostError": (".core", "BifrostError"),
          "core_version": (".core", "version"),
          "proclog_dir": (".proclog", "proclog_dir"),
          "Space": (".memory", "Space"),
          "space_accessible": (".memory", "space_accessible")}
_ATTRS.update({n: (".ndarray", n) for n in (
    "asarray", "empty", "zeros", "empty_like", "zeros_like", "copy_array",
    "memset_array", "get_space")})


def _class_of_module(name):
    """A property giving the class `name` of the module `.name`: importing
    a submodule binds its name on the package, and the property keeps
    the class there, as the JAX package's eager imports do
    (`from bifrost_tpu_torch.ndarray import ...` still reads the
    module)."""

    def get(self):
        return getattr(importlib.import_module(f".{name}", __name__), name)

    def set_(self, module):
        pass    # the import system's binding of the submodule
    return property(get, set_)


class _Package(types.ModuleType):
    DataType = _class_of_module("DataType")
    ndarray = _class_of_module("ndarray")


sys.modules[__name__].__class__ = _Package


def __getattr__(name):
    if name in _SUBMODULES:
        value = importlib.import_module(f".{name}", __name__)
    elif name in _MODULE_ALIASES:
        value = importlib.import_module(_MODULE_ALIASES[name], __name__)
    elif name in _ATTRS:
        module, attr = _ATTRS[name]
        value = getattr(importlib.import_module(module, __name__), attr)
    else:
        raise AttributeError(
            f"module 'bifrost_tpu_torch' has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


__all__ = sorted(set(_SUBMODULES) | set(_MODULE_ALIASES) | set(_ATTRS) |
                 {"DataType", "ndarray"})
