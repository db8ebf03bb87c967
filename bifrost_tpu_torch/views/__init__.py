"""Zero-copy header-transform views (counterpart of bifrost_tpu/views)."""

from .basic_views import (add_axis, astype, custom, delete_axis, merge_axes,
                          reinterpret_axis, rename_axis, reverse_scale,
                          split_axis)

__all__ = ["custom", "rename_axis", "reinterpret_axis", "reverse_scale",
           "add_axis", "delete_axis", "astype", "split_axis", "merge_axes"]
