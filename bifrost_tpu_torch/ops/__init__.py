"""Device ops of the port (counterparts of bifrost_tpu/ops)."""

from .beamform import Beamform
from .fdmt import Fdmt, plan_from_reference
from .fft import Fft
from .fftshift import fftshift
from .pfb import Pfb, pfb, pfb_coeffs
from .romein import Romein, separate_kernels
from .transpose import transpose
from . import stats

__all__ = ["Beamform", "Fdmt", "plan_from_reference", "Fft", "fftshift",
           "Pfb", "pfb", "pfb_coeffs", "Romein", "separate_kernels",
           "transpose", "stats"]
