"""Memory spaces (counterpart of bifrost_tpu/memory.py).

Spaces: 'system' (host memory), 'cuda' (device memory of the pipeline's
torch device) and 'cuda_host' (pinned host memory, the H2D staging space;
it takes the place of the JAX package's 'tpu_host').  A space names where
a ring keeps its bytes; the torch device that backs 'cuda' is the
pipeline's, so a pipeline built with ``device='cpu'`` (the tests) keeps
its 'cuda' rings in host memory, as the JAX package's 'tpu' space runs on
JAX's CPU backend in its tests.  The module imports torch at first
allocation, so the observability tools, which read its space names, start
without it.
"""

from __future__ import annotations

SPACES = ("system", "cuda", "cuda_host")
# Space numbers as the JAX engine logs them in a ring's `space` key
# (cpp/include/btcore.h BTspace: 'tpu' is 2, 'tpu_host' 3), for the
# observability tools.
SPACEMAP = {"auto": 0, "system": 1, "cuda": 2, "cuda_host": 3}
SPACEMAP_INV = {0: "auto", 1: "system", 2: "cuda", 3: "cuda_host"}
# Spellings of the JAX package and the reference, accepted so pipelines
# port without edits.
_ALIASES = {"auto": "system", "tpu": "cuda", "tpu_host": "cuda_host",
            "cuda_managed": "cuda"}


class Space(object):
    def __init__(self, s):
        if isinstance(s, Space):
            s = s.space
        s = _ALIASES.get(s, s)
        if s not in SPACES:
            raise ValueError(f"invalid space: {s!r}")
        self.space = s

    def __eq__(self, other):
        return self.space == Space(other).space

    def __hash__(self):
        return hash(self.space)

    def __str__(self):
        return self.space

    def __repr__(self):
        return f"Space('{self.space}')"


def space_device(space, device):
    """The torch device that holds `space`'s bytes in a pipeline bound to
    `device`: 'cuda' lives on `device`, the host spaces on the CPU."""
    import torch
    return torch.device(device) if Space(space).space == "cuda" \
        else torch.device("cpu")


def alloc_bytes(shape, space, device):
    """Uninitialized uint8 tensor of `shape` in `space`.  'cuda_host' is
    pinned when `device` is a CUDA device (on a CPU-bound pipeline there
    is nothing to pin for)."""
    import torch
    dev = space_device(space, device)
    pin = Space(space).space == "cuda_host" and \
        torch.device(device).type == "cuda"
    return torch.empty(shape, dtype=torch.uint8, device=dev, pin_memory=pin)
