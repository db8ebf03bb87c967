"""Gridder block: streams visibility gulps through a Romein plan
(counterpart of bifrost_tpu/blocks/romein.py; reference src/romein.cu
driven per gulp).

Input axes [..., 'vis', 'time'] (time is the frame axis): each frame is
one set of `nvis` visibilities per leading ("pol") plane.  Each output
frame is that frame's visibilities gridded onto an (ngrid, ngrid) UV
plane per leading plane: output axes [..., 'v', 'u', 'time'].

Positions and kernels are plan state, set once per sequence: an array, a
callable ``f(header)`` returning one, or (positions only) the header key
`positions_key` (default 'uvw'), from either origin (ops/romein.py):
numpy arrays or lists take the host plan builders, a tensor (a callable
returning card tensors: UVW computed on the card by an earlier stage)
the torch builders on its device, with bitwise the same tables.  The
resolved method, the plan's origin and its build time are published
once per sequence, after the first execute, on the `<name>/romein_plan`
proclog channel (the JAX block's keys: method, origin, plan_build_s,
ngrid, m).  `method=` (None reads the
`romein_method` config flag) is resolved once per sequence and latched.
Every frame is one launch of K6b (rank-1 kernels) or K6a (any other
kernel) over all planes, written straight into the output span.  A
'cuda' ring carrying ci4 or ci8 is read in raw storage form
(`ReadSpan.data_storage`, 1 or 2 B/sample), unpacked to complex and then
gridded, as the JAX block's raw ingest does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ndarray import complex_view
from ..ops.romein import Romein
from ..ops.runtime import staged_unpack
from ..pipeline import TransformBlock
from ._common import deepcopy_header


class GridderBlock(TransformBlock):

    # Under the async executor the worker reserves this block's output,
    # one open reservation at a time (pipeline.py,
    # async_reserve_ahead).
    async_reserve_ahead = False

    def __init__(self, iring, ngrid, kernels, positions=None,
                 positions_key="uvw", method=None, precision="f32", *args,
                 **kwargs):
        """kernels: complex kernels broadcastable to (npol, nvis, m, m),
        or a callable(hdr) returning them (numpy or a tensor).
        positions: (2, ..., nvis) int grid positions (patch corners),
        numpy or a tensor, or a callable(hdr) returning them; None reads
        `positions_key` from the input header.  method: None resolves the
        `romein_method` config flag ('auto'/'cuda'/'plain') per
        sequence."""
        super().__init__(iring, *args, **kwargs)
        if precision != "f32":
            raise ValueError(
                f"romein: precision {precision!r} is the JAX package's "
                f"single-pass MXU mode; the port grids in f32 only")
        self.ngrid = int(ngrid)
        self.kernels = kernels
        self.positions = positions
        self.positions_key = positions_key
        self.method = method
        self.romein = Romein()

    def _resolve(self, spec, hdr, what):
        if callable(spec):
            return spec(hdr)
        if spec is None:
            if what not in hdr:
                raise KeyError(f"{self.name}: no '{what}' in the input "
                               f"header and no explicit argument")
            return np.asarray(hdr[what])
        return spec

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        labels = itensor["labels"]
        if labels[-1] != "time" or labels[-2] != "vis":
            raise KeyError(f"Expected axes [..., 'vis', 'time'], got "
                           f"{labels}")
        self._dtype = iseq.tensor.dtype
        self._npol = int(np.prod([int(s) for s in itensor["shape"][:-2]]))
        self._nvis = int(itensor["shape"][-2])
        positions = self._resolve(self.positions, ihdr, self.positions_key)
        kernels = self._resolve(self.kernels, ihdr, "gridding_kernels")
        self.romein.init(positions, kernels, self.ngrid, method=self.method)
        # Resolved once per sequence, the flag latched.
        self.romein.method = self.romein._resolve()
        self._hold_flag_latch("romein_method")
        self._reported = False     # the plan's proclog row, once
        self._raw_reads = 0        # gulps read in raw storage form
        self._raw_read_nbyte = 0   # bytes those reads covered
        ohdr = deepcopy_header(ihdr)
        ot = ohdr["_tensor"]
        ot["dtype"] = "cf32"
        ot["shape"] = list(ot["shape"][:-2]) + [self.ngrid, self.ngrid, -1]
        ot["labels"] = list(labels[:-2]) + ["v", "u", "time"]
        scales = list(ot.get("scales") or [None] * len(labels))
        units = list(ot.get("units") or [None] * len(labels))
        ot["scales"] = scales[:-2] + [[0, 1], [0, 1], scales[-1]]
        ot["units"] = units[:-2] + [None, None, units[-1]]
        return ohdr

    def on_data(self, ispan, ospan):
        nframe = min(ispan.nframe, ospan.nframe)
        out = ospan.data
        raw = ispan.data_storage
        if raw is not None:
            re, im = staged_unpack(raw, self._dtype)
            x = torch.complex(re, im)
            self._raw_reads += 1
            self._raw_read_nbyte += raw.numel() * raw.element_size()
        elif self._dtype.is_complex and self._dtype.is_integer:
            x = complex_view(ispan.data, self._dtype)
        else:
            x = ispan.data
        if not x.is_complex():
            x = x.to(torch.complex64)
        n = self.ngrid
        for f in range(nframe):
            self.romein.execute(
                x[..., f].reshape(self._npol, self._nvis),
                out[..., f].view(self._npol, n, n), accumulate=False)
            if not self._reported:
                # Right after the first execute, while plan_build_s
                # still holds the build (later frames hit the cache).
                self._report_plan()
        return nframe

    def _report_plan(self):
        rep = self.romein.plan_report()
        if not hasattr(self, "_plan_proclog"):
            from ..proclog import ProcLog
            self._plan_proclog = ProcLog(f"{self.name}/romein_plan")
        self._plan_proclog.update({
            "method": rep["method"], "origin": rep["origin"],
            "plan_build_s": round(rep["plan_build_s"], 6),
            "ngrid": self.ngrid, "m": self.romein.m})
        self._reported = True

    def plan_report(self):
        return self.romein.plan_report()


def romein(iring, ngrid, kernels, positions=None, positions_key="uvw",
           method=None, precision="f32", *args, **kwargs):
    """Grid visibility streams onto UV planes with a Romein plan
    (ops/romein.py; one grid per input frame, all planes in one launch of
    kernel K6a or K6b)."""
    return GridderBlock(iring, ngrid, kernels, positions, positions_key,
                        method, precision, *args, **kwargs)
