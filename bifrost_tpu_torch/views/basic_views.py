"""Zero-copy header-rewrite views (counterpart of
bifrost_tpu/views/basic_views.py; reference python/bifrost/views/
basic_views.py): the data is untouched, only the header a downstream
reader sees changes."""

from __future__ import annotations

import math

from ..DataType import DataType
from ..pipeline import block_view
from ..units import convert_units


def _axis(tensor, axis):
    return tensor["labels"].index(axis) if isinstance(axis, str) else axis


def custom(block, hdr_transform):
    """Alias of `bifrost_tpu_torch.pipeline.block_view`."""
    return block_view(block, hdr_transform)


def rename_axis(block, old, new):
    def header_transform(hdr):
        axis = hdr["_tensor"]["labels"].index(old)
        hdr["_tensor"]["labels"][axis] = new
        return hdr
    return block_view(block, header_transform)


def reinterpret_axis(block, axis, label=None, scale=None, units=None):
    """Manually reinterpret the label/scale/units of an axis."""
    def header_transform(hdr):
        tensor = hdr["_tensor"]
        ax = _axis(tensor, axis)
        if label is not None:
            tensor["labels"][ax] = label
        if scale is not None:
            tensor["scales"][ax] = list(scale)
        if units is not None:
            tensor["units"][ax] = units
        return hdr
    return block_view(block, header_transform)


def reverse_scale(block, axis):
    """Negate the scale step on an axis."""
    def header_transform(hdr):
        tensor = hdr["_tensor"]
        tensor["scales"][_axis(tensor, axis)][1] *= -1
        return hdr
    return block_view(block, header_transform)


def add_axis(block, axis, label=None, scale=None, units=None):
    """Insert a length-1 axis (string axis => insert after that axis)."""
    def header_transform(hdr):
        tensor = hdr["_tensor"]
        ax = axis
        if isinstance(ax, str):
            ax = tensor["labels"].index(ax) + 1
        if ax < 0:
            ax += len(tensor["shape"]) + 1
        tensor["shape"].insert(ax, 1)
        for key, val in (("labels", label), ("scales", scale),
                         ("units", units)):
            if key in tensor and tensor[key] is not None:
                tensor[key].insert(ax, val)
        return hdr
    return block_view(block, header_transform)


def delete_axis(block, axis):
    """Remove a length-1 axis."""
    def header_transform(hdr):
        tensor = hdr["_tensor"]
        ax = _axis(tensor, axis)
        if ax < 0:
            ax += len(tensor["shape"])
        if tensor["shape"][ax] != 1:
            raise ValueError(f"Cannot delete non-unitary axis {axis} with "
                             f"shape {tensor['shape'][ax]}")
        for key in ("shape", "labels", "scales", "units"):
            if key in tensor and tensor[key] is not None:
                del tensor[key][ax]
        return hdr
    return block_view(block, header_transform)


def astype(block, dtype):
    """Reinterpret the last axis with a new element type (byte punning:
    a reader sees the span's bytes under the new type, its storage form
    included, e.g. one i16 per ci8 sample, re in the low byte)."""
    def header_transform(hdr):
        tensor = hdr["_tensor"]
        old_itemsize = DataType(tensor["dtype"]).itemsize
        new_itemsize = DataType(dtype).itemsize
        old_axissize = old_itemsize * tensor["shape"][-1]
        if old_axissize % new_itemsize:
            raise ValueError("New type not compatible with data shape")
        tensor["shape"][-1] = old_axissize // new_itemsize
        tensor["dtype"] = str(DataType(dtype))
        return hdr
    return block_view(block, header_transform)


def split_axis(block, axis, n, label=None):
    """Split an axis into (axis, n); splitting the frame axis rescales
    gulp_nframe (bifrost_tpu/views/basic_views.py:98-128)."""
    def header_transform(hdr):
        tensor = hdr["_tensor"]
        ax = _axis(tensor, axis)
        shape = tensor["shape"]
        if shape[ax] == -1:
            hdr["gulp_nframe"] = (hdr["gulp_nframe"] - 1) // n + 1
        else:
            if shape[ax] % n:
                raise ValueError(f"Split does not evenly divide axis "
                                 f"({shape[ax]} // {n})")
            shape[ax] //= n
        shape.insert(ax + 1, n)
        if "units" in tensor and tensor["units"] is not None:
            tensor["units"].insert(ax + 1, tensor["units"][ax])
        if "labels" in tensor and tensor["labels"] is not None:
            lab = label if label is not None else \
                tensor["labels"][ax] + "_split"
            tensor["labels"].insert(ax + 1, lab)
        if "scales" in tensor and tensor["scales"] is not None:
            tensor["scales"].insert(ax + 1, [0, tensor["scales"][ax][1]])
            tensor["scales"][ax][1] *= n
        return hdr
    return block_view(block, header_transform)


def merge_axes(block, axis1, axis2, label=None):
    """Merge two adjacent axes; merging into the frame axis rescales
    gulp_nframe (bifrost_tpu/views/basic_views.py:130-174).  Where both
    axes carry scales they must line up (the outer step is n times the
    inner one, in the outer axis's units)."""
    def header_transform(hdr):
        tensor = hdr["_tensor"]
        a1, a2 = _axis(tensor, axis1), _axis(tensor, axis2)
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
