"""bifrost_tpu_torch: the PyTorch and CUDA port of bifrost_tpu, for NVIDIA
Hopper.  It mirrors the JAX package's module names and imports nothing
of it (nor JAX).  Entry points run on the card unless the caller passes
``device='cpu'``."""

from . import blocks, config, device, ops, views
from .DataType import DataType
from .pipeline import (Block, BlockScope, MultiTransformBlock, Pipeline,
                       SinkBlock, SourceBlock, TransformBlock, block_scope,
                       get_default_pipeline)
from .ring import EndOfDataStop, Ring, RingInterrupted

__all__ = ["blocks", "config", "device", "ops", "views", "DataType", "Block",
           "BlockScope", "MultiTransformBlock", "Pipeline", "SinkBlock",
           "SourceBlock", "TransformBlock", "block_scope",
           "get_default_pipeline", "EndOfDataStop", "Ring",
           "RingInterrupted"]
