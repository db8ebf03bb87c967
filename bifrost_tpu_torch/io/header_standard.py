"""The framework's standard sequence-header convention
(reference: python/bifrost/header_standard.py — a minimal required-keys spec
used to validate headers crossing block boundaries).

Required: a `_tensor` dict with 'dtype' and 'shape' (exactly one -1 frame
axis); recommended: labels/scales/units aligned with shape, plus top-level
name/time_tag.

The port's own copy of bifrost_tpu/io/header_standard.py (numpy only, kept
verbatim so that both packages read and write the same bytes).
"""

from __future__ import annotations

REQUIRED_TENSOR_KEYS = ("dtype", "shape")
RECOMMENDED_TENSOR_KEYS = ("labels", "scales", "units")
RECOMMENDED_TOP_KEYS = ("name", "time_tag")


def enforce_header_standard(header, strict=False):
    """Validate a sequence header; returns (ok, problems)."""
    problems = []
    if not isinstance(header, dict):
        return False, ["header is not a dict"]
    tensor = header.get("_tensor")
    if not isinstance(tensor, dict):
        return False, ["missing '_tensor' dict"]
    for key in REQUIRED_TENSOR_KEYS:
        if key not in tensor:
            problems.append(f"missing _tensor['{key}']")
    shape = tensor.get("shape")
    if isinstance(shape, list):
        if shape.count(-1) != 1:
            problems.append(f"_tensor shape {shape} must have exactly one -1 "
                            "(frame) axis")
        for key in RECOMMENDED_TENSOR_KEYS:
            val = tensor.get(key)
            if val is not None and len(val) != len(shape):
                problems.append(f"_tensor['{key}'] length {len(val)} != "
                                f"rank {len(shape)}")
    for key in RECOMMENDED_TOP_KEYS:
        if key not in header:
            problems.append(f"missing recommended header key '{key}'")
    if strict:
        return len(problems) == 0, problems
    fatal = [p for p in problems if p.startswith("missing _tensor") or
             "frame" in p or "rank" in p]
    return len(fatal) == 0, problems
