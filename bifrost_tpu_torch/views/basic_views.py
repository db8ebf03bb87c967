"""Zero-copy header-rewrite views (counterpart of
bifrost_tpu/views/basic_views.py; reference python/bifrost/views/
basic_views.py): the data is untouched, only the header a downstream
reader sees changes."""

from __future__ import annotations

import math

from ..pipeline import block_view
from ..units import convert_units


def merge_axes(block, axis1, axis2, label=None):
    """Merge two adjacent axes; merging into the frame axis rescales
    gulp_nframe (bifrost_tpu/views/basic_views.py:130-174).  Where both
    axes carry scales they must line up (the outer step is n times the
    inner one, in the outer axis's units)."""
    def header_transform(hdr):
        tensor = hdr["_tensor"]
        a1 = tensor["labels"].index(axis1) if isinstance(axis1, str) \
            else axis1
        a2 = tensor["labels"].index(axis2) if isinstance(axis2, str) \
            else axis2
        a1, a2 = sorted([a1, a2])
        if a2 != a1 + 1:
            raise ValueError("Merge axes must be adjacent")
        n = tensor["shape"][a2]
        if n == -1:
            raise ValueError("Second merge axis cannot be frame axis")
        if tensor["shape"][a1] == -1:
            hdr["gulp_nframe"] *= n
        else:
            tensor["shape"][a1] *= n
        del tensor["shape"][a2]
        if "scales" in tensor and "units" in tensor and \
                tensor["scales"] is not None and tensor["units"] is not None:
            s1 = tensor["scales"][a1]
            s2 = tensor["scales"][a2]
            if s1 is not None and s2 is not None:
                scale2 = convert_units(s2[1], tensor["units"][a2],
                                       tensor["units"][a1])
                if not math.isclose(s1[1], n * scale2, rel_tol=1e-6):
                    raise ValueError(f"Scales of merge axes do not line "
                                     f"up: {s1[1]} != {n * scale2}")
                tensor["scales"][a1] = [s1[0], scale2]
            elif s2 is not None:
                # the inner axis carries the fine step: adopt its scale
                # and units
                tensor["scales"][a1] = list(s2)
                tensor["units"][a1] = tensor["units"][a2]
            elif s1 is not None:
                # only the coarse axis was scaled: the merged axis is n
                # times denser, so the step shrinks by n
                tensor["scales"][a1] = [s1[0], s1[1] / n]
            del tensor["scales"][a2]
            del tensor["units"][a2]
        if "labels" in tensor and tensor["labels"] is not None:
            if label is not None:
                tensor["labels"][a1] = label
            del tensor["labels"][a2]
        return hdr
    return block_view(block, header_transform)
