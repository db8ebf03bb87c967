"""Copy block: move data between memory spaces (counterpart of
bifrost_tpu/blocks/copy.py; reference python/bifrost/blocks/copy.py — the
explicit H2D/D2H stage).

H2D runs asynchronously on the block's stream from pinned memory: a
'cuda_host' input span is pinned already, and the span's release waits
for the copy's event; a 'system' input is first copied into one of two
pinned staging buffers, each reused only after its previous copy's event
has completed.  The output span's commit event then orders the readers'
streams after the copy.

Fusion: as the head of a fused group (fuse.py), `device_kernel()` copies
the host gulp to the card inside the group, by the same staging.
"""

from __future__ import annotations

import torch

from .. import device as _device
from ..memory import Space
from ..pipeline import TransformBlock
from ._common import deepcopy_header


class CopyBlock(TransformBlock):
    def __init__(self, iring, space=None, *args, **kwargs):
        self._target_space = space
        super().__init__(iring, *args, **kwargs)
        self._staging = [None, None]     # (pinned tensor, its last event)
        self._slot = 0

    def _output_space(self):
        if self._target_space is not None:
            return str(Space(self._target_space))
        return super()._output_space()

    def on_sequence(self, iseq):
        return deepcopy_header(iseq.header)

    def _stage(self, src):
        """A pinned buffer holding `src`, free of earlier copies."""
        slot = self._slot
        self._slot ^= 1
        buf, ev = self._staging[slot] or (None, None)
        if ev is not None:
            ev.synchronize()
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return slot, buf

    def _h2d(self, src, dst):
        """Start the copy of host tensor `src` into device tensor `dst`
        on this thread's stream -> the event until which `src` must not
        be released (a pinned span read in place), else None."""
        if src.is_pinned():
            dst.copy_(src, non_blocking=True)
            return _device.record_event(self.device)
        slot, buf = self._stage(src)
        dst.copy_(buf, non_blocking=True)
        self._staging[slot] = (buf, _device.record_event(self.device))
        return None

    def on_data(self, ispan, ospan):
        ispace, ospace = self.iring.space, self.orings[0].space
        src, dst = ispan.data, ospan.data
        if ospace == "cuda" and ispace != "cuda" and dst.is_cuda:
            ispan.hold_until(self._h2d(src, dst))
        else:
            # Same-space copies, and D2H (host outputs are synchronised
            # before their commit).
            dst.copy_(src)

    def device_kernel(self):
        """The H2D head stage of a fused group: fn(host span tensor) ->
        (its copy on the group's device, the event to hold the span
        until or None).  On the CPU the copy is a snapshot (the ring
        reuses the span's bytes)."""
        dev = torch.device(self.device)

        def h2d(x):
            if dev.type != "cuda":
                return x.clone(), None
            y = torch.empty(x.shape, dtype=x.dtype, device=dev)
            return y, self._h2d(x, y)
        return h2d


def copy(iring, space=None, *args, **kwargs):
    """Copy data, possibly to another space (reference blocks/copy.py:51-73)."""
    return CopyBlock(iring, space, *args, **kwargs)
