"""bifrost_tpu_torch: the PyTorch and CUDA port of bifrost_tpu, for NVIDIA
Hopper.  It mirrors the JAX package's module names and imports nothing
of it (nor JAX).  Entry points run on the card unless the caller passes
``device='cpu'``.

Every name below is imported at first use, as the JAX package's
``__init__`` imports its higher layers: ``import bifrost_tpu_torch`` loads
neither torch nor a block, so the observability tools (``python -m
bifrost_tpu_torch.tools.like_top``), which read only the proclog tree,
start at once beside a running pipeline."""

import importlib

_SUBMODULES = ("affinity", "blocks", "block_chainer", "cache", "config",
               "core", "device", "egress", "faultinject", "fleet",
               "interop", "io", "ops", "pipeline", "proclog", "ring",
               "service", "shmring", "supervise", "telemetry",
               "temp_storage", "tools", "trace", "udp", "units", "views")
_ATTRS = {"BlockChainer": ".block_chainer", "DataType": ".DataType",
          "Block": ".pipeline", "BlockScope": ".pipeline",
          "MultiTransformBlock": ".pipeline", "Pipeline": ".pipeline",
          "SinkBlock": ".pipeline", "SourceBlock": ".pipeline",
          "TransformBlock": ".pipeline", "block_scope": ".pipeline",
          "get_default_pipeline": ".pipeline",
          "EndOfDataStop": ".ring", "Ring": ".ring",
          "RingInterrupted": ".ring"}


def __getattr__(name):
    if name in _SUBMODULES:
        value = importlib.import_module(f".{name}", __name__)
    elif name == "map":
        # bf.map: the module (ops.map the attribute is the eager
        # function), as bifrost_tpu exposes .ops.map.
        value = importlib.import_module(".ops.map", __name__)
    elif name in _ATTRS:
        value = getattr(importlib.import_module(_ATTRS[name], __name__),
                        name)
    else:
        raise AttributeError(
            f"module 'bifrost_tpu_torch' has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


__all__ = ["affinity", "blocks", "config", "device", "egress", "interop",
           "io", "ops", "shmring", "temp_storage", "views",
           "BlockChainer", "DataType", "Block",
           "BlockScope", "MultiTransformBlock", "Pipeline", "SinkBlock",
           "SourceBlock", "TransformBlock", "block_scope",
           "get_default_pipeline", "EndOfDataStop", "Ring",
           "RingInterrupted", "map", "core", "trace", "tools",
           "telemetry", "proclog"]
