"""Convert visibility matrix layouts (counterpart of
bifrost_tpu/blocks/convert_visibilities.py; reference
python/bifrost/blocks/convert_visibilities.py): the correlator's
['time', 'freq', 'station_i', 'pol_i', 'station_j', 'pol_j'] matrix to

- 'matrix': the full Hermitian matrix, the empty triangle filled from the
  conjugate transpose over (station, pol), the diagonal stations kept
  (``where(|x| > 0, x, x^H)``);
- 'storage': the lower-triangle baseline list [time, freq, baseline,
  pol_i, pol_j], baselines in `np.tril_indices` order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..pipeline import TransformBlock
from ._common import deepcopy_header, store

_LABELS = ["time", "freq", "station_i", "pol_i", "station_j", "pol_j"]


def fill_hermitian(x):
    """(t, f, si, pi, sj, pj) -> the full Hermitian matrix."""
    xt = x.permute(0, 1, 4, 5, 2, 3).conj()
    n = x.shape[2]
    eye = torch.eye(n, dtype=torch.bool, device=x.device)[
        None, None, :, None, :, None]
    return torch.where(eye, x, torch.where(x.abs() > 0, x, xt))


def to_storage(x, bl_i, bl_j):
    """(t, f, si, pi, sj, pj) -> (t, f, baseline, pi, pj)."""
    return x[:, :, bl_i, :, bl_j, :].permute(1, 2, 0, 3, 4)


class ConvertVisibilitiesBlock(TransformBlock):
    def __init__(self, iring, fmt, *args, **kwargs):
        if fmt not in ("matrix", "storage"):
            raise ValueError(f"unsupported visibility format: {fmt}")
        super().__init__(iring, *args, **kwargs)
        self.fmt = fmt

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        if itensor["labels"] != _LABELS:
            raise ValueError(f"bad input labels {itensor['labels']}")
        ohdr = deepcopy_header(ihdr)
        if self.fmt == "matrix":
            ohdr["matrix_fill_mode"] = "hermitian"
            return ohdr
        otensor = ohdr["_tensor"]
        nstand, npol = itensor["shape"][2], itensor["shape"][3]
        otensor["shape"] = [-1, itensor["shape"][1],
                            nstand * (nstand + 1) // 2, npol, npol]
        otensor["labels"] = ["time", "freq", "baseline", "pol_i", "pol_j"]
        otensor["scales"] = [itensor["scales"][0], itensor["scales"][1],
                             None, None, None]
        otensor["units"] = [itensor["units"][0], itensor["units"][1],
                            None, None, None]
        ohdr.pop("matrix_fill_mode", None)
        i, j = np.tril_indices(nstand)
        self._bl = (torch.from_numpy(i), torch.from_numpy(j))
        return ohdr

    def on_data(self, ispan, ospan):
        x = ispan.data
        if self.fmt == "matrix":
            store(ospan, fill_hermitian(x))
        else:
            bl_i, bl_j = (t.to(x.device) for t in self._bl)
            store(ospan, to_storage(x, bl_i, bl_j))


def convert_visibilities(iring, fmt, *args, **kwargs):
    """Convert visibility data between matrix/storage formats
    (reference blocks/convert_visibilities.py:184-211)."""
    return ConvertVisibilitiesBlock(iring, fmt, *args, **kwargs)
