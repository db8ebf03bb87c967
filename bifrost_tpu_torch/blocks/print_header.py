"""Print-header debugging block (counterpart of bifrost_tpu/blocks/
print_header.py; reference python/bifrost/blocks/print_header.py): each
sequence header as indented JSON, the same text the JAX block prints."""

from __future__ import annotations

import json

from ..pipeline import SinkBlock

__all__ = ["PrintHeaderBlock", "print_header"]


class PrintHeaderBlock(SinkBlock):
    def on_sequence(self, iseq):
        print(json.dumps(iseq.header, indent=2, default=str))

    def on_data(self, ispan):
        pass


def print_header(iring, *args, **kwargs):
    """Print every sequence header that flows past."""
    return PrintHeaderBlock(iring, *args, **kwargs)
