"""Device ops of the port (counterparts of bifrost_tpu/ops)."""

from .beamform import Beamform
from .fdmt import Fdmt, plan_from_reference
from .pfb import Pfb, pfb, pfb_coeffs
from .transpose import transpose
from . import stats

__all__ = ["Beamform", "Fdmt", "plan_from_reference", "Pfb", "pfb",
           "pfb_coeffs", "transpose", "stats"]
