"""Batched linear algebra (counterpart of bifrost_tpu/ops/linalg.py;
reference src/linalg.cu, python/bifrost/linalg.py).

``LinAlg().matmul(alpha, a, b, beta, out)`` computes ``out = alpha *
a @ b + beta * out``; with ``b=None`` the Hermitian product ``alpha *
a @ a^H + beta * out``, with ``a=None`` ``alpha * b^H @ b + beta * out``
(the correlator form; reference linalg.h:48-54).  The products are
`torch.matmul` with TF32 off, as the JAX package leaves them to
`jnp.matmul` outside any kernel.  Complex-integer inputs (ci4/ci8/ci16,
given with their `dtype`) lift to complex64 first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from ..ndarray import complex_view
from .unpack import unpack_logical


def _operand(x, dtype):
    """An input (tensor or numpy, in storage form for a complex-integer
    `dtype`) -> its logical tensor."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype.names is not None:          # structured complex int
            dtype = dtype or DataType(a.dtype)
            a = a.view(a.dtype[0]).reshape(a.shape + (2,))
        x = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        dt = DataType(dtype)
        if dt.is_complex and dt.is_integer:
            return unpack_logical(x, dt) if dt.nbit < 8 else \
                complex_view(x, dt)
    return x


class LinAlg(object):
    """Plan-object API mirroring the reference (linalg.py:37-67)."""

    def matmul(self, alpha, a, b, beta, out, a_dtype=None, b_dtype=None):
        """out = alpha*a·b + beta*out; b=None -> alpha*a·aᴴ + beta*out;
        a=None -> alpha*bᴴ·b + beta*out.  With `out` None (or beta 0)
        the product is returned; else it is written into `out` too."""
        if a is None and b is None:
            raise ValueError("matmul needs at least one of a, b")
        ta = _operand(a, a_dtype) if a is not None else None
        tb = _operand(b, b_dtype) if b is not None else None
        dev = (ta if ta is not None else tb).device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        if b is None:
            y = torch.matmul(ta, ta.mH)
        elif a is None:
            y = torch.matmul(tb.mH, tb)
        else:
            y = torch.matmul(ta, tb)
        y = (1.0 if alpha is None else alpha) * y
        if beta is not None and beta != 0 and out is not None:
            prev = out if isinstance(out, torch.Tensor) else \
                torch.from_numpy(np.asarray(out))
            y = y + beta * prev.to(y.device)
        if out is None:
            return y
        if isinstance(out, torch.Tensor):
            return out.copy_(y)
        np.asarray(out)[...] = y.cpu().numpy()
        return out
