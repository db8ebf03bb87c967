"""Shared plan runtime for device ops (counterpart of the core of
bifrost_tpu/ops/runtime.py:85-264): method resolution through a config
flag (which blocks latch per sequence, config.py), a bounded plan cache
keyed by the RESOLVED method, and the uniform `report()` core every op's
`plan_report()` embeds:

    {"op", "method", "origin", "plan_build_s",
     "cache": {"entries", "capacity", "hits", "misses", "evictions"}}

It also holds the staged-unpack helpers (bifrost_tpu/ops/runtime.py:
266-320): a raw ring-storage gulp (packed ci4 bytes, or ci8 and wider
(re, im) pairs) becomes f32 (re, im) planes.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from ..DataType import DataType

DEFAULT_CAPACITY = 64


def staged_unpack(raw, dtype):
    """Raw ring storage of a complex-integer stream (packed ci4 bytes,
    one sample a byte; ci8/ci16/ci32: the integer component type with a
    trailing (re, im) axis of 2) -> f32 (re, im) planes of its logical
    shape.  The lift is exact."""
    dt = DataType(dtype)
    if not (dt.is_complex and dt.is_integer):
        raise ValueError(f"staged_unpack expects a complex-integer ring "
                         f"dtype, got {dt}")
    if dt.nbit < 8:
        from .unpack import unpack_pairs
        raw = unpack_pairs(raw, dt)
    elif raw.shape[-1] != 2:
        raise ValueError(f"{dt} storage needs a trailing (re, im) axis of "
                         f"2, got shape {tuple(raw.shape)}")
    return raw[..., 0].float(), raw[..., 1].float()


def staged_unpack_canonical(raw, dtype, perm):
    """`staged_unpack`, then the planes permuted by `perm` (header axis
    order -> (time, freq, station, pol)); expansion first, as the JAX
    helper orders it."""
    re, im = staged_unpack(raw, dtype)
    perm = tuple(perm)
    return re.permute(perm), im.permute(perm)


def storage_nbyte_per_sample(dtype):
    """Ring bytes a logical sample of a complex-integer stream read in
    storage form: 1 for ci4, 2 for ci8, 4 for ci16..."""
    dt = DataType(dtype)
    if not (dt.is_complex and dt.is_integer):
        raise ValueError(f"storage form is defined for complex-integer "
                         f"dtypes, got {dt}")
    return max(2 * dt.nbit // 8, 1)


class OpRuntime(object):
    """Plan cache + method resolution for one op instance.

    ``methods`` are the valid resolved methods (never 'auto');
    ``config_flag`` is consulted when the method is None/'auto';
    ``default`` is what 'auto' resolves to when the flag says 'auto'
    (None: 'auto' stays 'auto', for an op that resolves it itself).
    Blocks that resolve once a sequence latch the flag (`hold_latch`),
    and the cache reads as a mapping (`get`, `keys`, `items`, `in`,
    `len`)."""

    def __init__(self, op, methods, config_flag=None, default=None,
                 capacity=DEFAULT_CAPACITY):
        self.op = str(op)
        self.methods = tuple(methods)
        self.config_flag = config_flag
        self.default = default
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"{op}: runtime cache capacity must be >= 1")
        self._cache = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.last_method = None
        self.last_origin = None
        self.last_plan_build_s = 0.0

    def resolve_method(self, method=None):
        """None/'auto' -> config flag -> default, validated."""
        if method is None:
            method = "auto"
        if method == "auto" and self.config_flag is not None:
            from .. import config
            method = config.get(self.config_flag)
        if method == "auto":
            if self.default is None:
                return "auto"
            method = self.default
        if method not in self.methods:
            flag = f" ({self.config_flag} config flag)" \
                if self.config_flag else ""
            raise ValueError(
                f"{self.op}: unknown method {method!r}{flag} "
                f"(expected auto/{'/'.join(self.methods)})")
        return method

    def hold_latch(self, owner):
        """Latch the op's config flag for a sequence (config.py's latch:
        `config.set` on it raises, naming `owner`); pair with
        `release_latch`."""
        if self.config_flag is not None:
            from .. import config
            config.hold_latch(self.config_flag, owner)

    def release_latch(self, owner):
        if self.config_flag is not None:
            from .. import config
            config.release_latch(self.config_flag, owner)

    def plan(self, key, build, method=None, origin=None):
        """Get-or-build the cached plan for ``key`` (bounded LRU).  A build
        that returns None is not cached; a plan's own `plan_build_s`
        attribute, where it times itself, is its build cost."""
        if method is not None:
            self.last_method = method
        if origin is not None:
            self.last_origin = origin
        entry = self._cache.get(key)
        if entry is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            self.last_plan_build_s = 0.0
            return entry
        self.misses += 1
        t0 = time.perf_counter()
        value = build()
        if value is None:
            return None
        self.last_plan_build_s = float(getattr(
            value, "plan_build_s", time.perf_counter() - t0))
        self._cache[key] = value
        while len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
            self.evictions += 1
        return value

    def invalidate(self):
        """Drop every cached plan; the counters survive."""
        self._cache.clear()

    def get(self, key, default=None):
        return self._cache.get(key, default)

    def __contains__(self, key):
        return key in self._cache

    def __len__(self):
        return len(self._cache)

    def __eq__(self, other):
        if isinstance(other, OpRuntime):
            return self is other
        return dict(self._cache) == other

    __hash__ = object.__hash__

    def keys(self):
        return self._cache.keys()

    def items(self):
        return self._cache.items()

    def report(self):
        return {
            "op": self.op,
            "method": self.last_method,
            "origin": self.last_origin,
            "plan_build_s": self.last_plan_build_s,
            "cache": {
                "entries": len(self._cache),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
            },
        }

    def publish_proclog(self, proclog, extra=None):
        """`report()` flattened onto a block's `<name>/<op>_plan` ProcLog
        (bifrost_tpu/ops/runtime.py:244-262): method, origin, build
        seconds and the cache's counters, plus `extra`."""
        rep = self.report()
        row = {"method": rep["method"], "origin": rep["origin"],
               "plan_build_s": round(rep["plan_build_s"], 6)}
        row.update({f"cache_{k}": v for k, v in rep["cache"].items()})
        if extra:
            row.update(extra)
        proclog.update(row)
        return row
