"""Pipeline blocks of the port (counterparts of bifrost_tpu/blocks)."""

from .beamform import beamform, BeamformBlock
from .copy import copy, CopyBlock
from .fdmt import fdmt, FdmtBlock
from .pfb import pfb, PfbBlock
from .testing import (array_source, ArraySourceBlock, callback_sink,
                      CallbackSinkBlock, gather_sink)
from .transpose import transpose, TransposeBlock

__all__ = ["beamform", "BeamformBlock", "copy", "CopyBlock", "fdmt",
           "FdmtBlock", "pfb", "PfbBlock", "array_source",
           "ArraySourceBlock", "callback_sink", "CallbackSinkBlock",
           "gather_sink", "transpose", "TransposeBlock"]
