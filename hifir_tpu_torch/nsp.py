"""Null-space filter for (nearly) singular systems.

The port's own copy of ``hifir_tpu/nsp.py:NspFilter`` on tensors, which also
stands for ``nsp_filter_device`` (``hifir_tpu/alg/prec.py:295``): after an
M-solve the solution is filtered against a known null space, either the
constant mode over a row range (its mean, complex for a complex solution,
is subtracted, column by column for a block) or a user callback, which
takes and returns what it is given.  The host solve
(``HIF.solve``) filters numpy arrays the same way.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["NspFilter", "nsp_filter"]


class NspFilter:
    """Constant-mode or user-defined null-space projector."""

    def __init__(self, start: int = 0, end: int = -1,
                 user_func: Optional[Callable[[torch.Tensor],
                                              torch.Tensor]] = None):
        self.start = start
        self.end = end
        self.user_func = user_func

    def filter(self, x):
        """The filtered copy of ``x``, a vector (n,) or a block (n, k), a
        tensor or a numpy array."""
        if self.user_func is not None:
            return self.user_func(x)
        end = x.shape[0] if self.end < 0 else self.end
        if isinstance(x, np.ndarray):
            x = np.array(x, copy=True)
            seg = x[self.start:end]
            seg -= seg.mean(axis=0, keepdims=True)
            return x
        x = x.clone()
        seg = x[self.start:end]
        seg -= seg.mean(dim=0, keepdim=True)
        return x


def nsp_filter(nsp: Optional[NspFilter], x: torch.Tensor) -> torch.Tensor:
    """``x`` filtered by ``nsp``, or ``x`` itself when there is none."""
    return x if nsp is None else nsp.filter(x)
