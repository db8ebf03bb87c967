"""Pipeline blocks of the port (counterparts of bifrost_tpu/blocks)."""

from .beamform import beamform, BeamformBlock
from .calibrate import broadcast_gains, gaincal, GainCalBlock
from .copy import copy, CopyBlock
from .correlate import correlate, CorrelateBlock
from .fdmt import fdmt, FdmtBlock
from .fft import fft, FftBlock
from .flag import rfi_flag, RfiFlagBlock
from .pfb import pfb, PfbBlock
from .romein import romein, GridderBlock
from .testing import (array_source, ArraySourceBlock, callback_sink,
                      CallbackSinkBlock, gather_sink)
from .transpose import transpose, TransposeBlock

__all__ = ["beamform", "BeamformBlock", "broadcast_gains", "gaincal",
           "GainCalBlock", "copy", "CopyBlock", "correlate",
           "CorrelateBlock", "fdmt", "FdmtBlock", "fft", "FftBlock",
           "rfi_flag", "RfiFlagBlock", "pfb",
           "PfbBlock", "romein", "GridderBlock", "array_source",
           "ArraySourceBlock", "callback_sink", "CallbackSinkBlock",
           "gather_sink", "transpose", "TransposeBlock"]
