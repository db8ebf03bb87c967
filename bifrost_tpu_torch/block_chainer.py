"""BlockChainer: fluent pipeline builder (counterpart of
bifrost_tpu/block_chainer.py; reference python/bifrost/block_chainer.py:
35-75), bound to the port's `blocks` and `views`.

Usage::

    bc = BlockChainer()
    bc.blocks.read_guppi_raw(files, gulp_nframe=1)
    bc.blocks.copy('cuda')
    bc.blocks.detect('stokes')
    bc.custom(my_block)(...)
"""

from __future__ import annotations


class _ChainProxy(object):
    def __init__(self, chainer, module):
        self._chainer = chainer
        self._module = module

    def __getattr__(self, name):
        func = getattr(self._module, name)

        def wrapper(*args, **kwargs):
            if self._chainer.last_block is not None:
                args = (self._chainer.last_block,) + args
            block = func(*args, **kwargs)
            self._chainer.last_block = block
            return block

        return wrapper


class BlockChainer(object):
    """Fluent builder: each `bc.blocks.foo(...)` / `bc.views.bar(...)` call
    receives the previous block as its input."""

    def __init__(self):
        self.last_block = None

    @property
    def blocks(self):
        from . import blocks
        return _ChainProxy(self, blocks)

    @property
    def views(self):
        from . import views
        return _ChainProxy(self, views)

    def custom(self, func):
        """Chain a user block factory (or an already-built block)."""
        def wrapper(*args, **kwargs):
            if self.last_block is not None:
                block = func(self.last_block, *args, **kwargs)
            else:
                block = func(*args, **kwargs)
            self.last_block = block
            return block
        if not callable(func):
            self.last_block = func
            return func
        return wrapper
