"""Zero-copy header-transform views (counterpart of bifrost_tpu/views).
Only `merge_axes` is ported so far."""

from .basic_views import merge_axes

__all__ = ["merge_axes"]
