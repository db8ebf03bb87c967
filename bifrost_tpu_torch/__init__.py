"""bifrost_tpu_torch: the PyTorch and CUDA port of bifrost_tpu, for NVIDIA
Hopper.  It mirrors the JAX package's module names and imports nothing
of it (nor JAX).  Entry points run on the card unless the caller passes
``device='cpu'``."""

import importlib

from . import blocks, config, device, egress, io, ops, views
from .block_chainer import BlockChainer
from .DataType import DataType
from .pipeline import (Block, BlockScope, MultiTransformBlock, Pipeline,
                       SinkBlock, SourceBlock, TransformBlock, block_scope,
                       get_default_pipeline)
from .ring import EndOfDataStop, Ring, RingInterrupted
# bf.map: the module (ops.map the attribute is the eager function), as
# bifrost_tpu exposes .ops.map.
map = importlib.import_module(".ops.map", __name__)  # noqa: A001

__all__ = ["blocks", "config", "device", "egress", "io", "ops", "views",
           "BlockChainer", "DataType", "Block",
           "BlockScope", "MultiTransformBlock", "Pipeline", "SinkBlock",
           "SourceBlock", "TransformBlock", "block_scope",
           "get_default_pipeline", "EndOfDataStop", "Ring",
           "RingInterrupted", "map"]
