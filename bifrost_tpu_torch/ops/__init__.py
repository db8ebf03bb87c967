"""Device ops of the port (counterparts of bifrost_tpu/ops)."""

from .beamform import Beamform
from .calibrate import (GainCal, calibrate, decode_gains, encode_gains,
                        fold_gains, gain_outer)
from .fdmt import Fdmt, plan_from_reference
from .fft import Fft
from .fftshift import fftshift
from .fir import Fir
from .flag import Flag, flag
from .linalg import LinAlg
from .pfb import Pfb, pfb, pfb_coeffs
from .quantize import Quantize, quantize, quantize_to
from .reduce import REDUCE_OPS, reduce, reduce_to
from .romein import Romein, separate_kernels
from .transpose import transpose
from .unpack import Unpack, unpack
from . import stats

__all__ = ["Beamform", "GainCal", "calibrate", "decode_gains",
           "encode_gains", "fold_gains", "gain_outer", "Fdmt",
           "plan_from_reference", "Fft", "fftshift", "Fir", "Flag", "flag",
           "Pfb", "pfb", "pfb_coeffs", "REDUCE_OPS", "reduce", "reduce_to",
           "Romein", "separate_kernels",
           "transpose", "stats", "LinAlg", "Quantize", "quantize",
           "quantize_to", "Unpack", "unpack"]
