"""User-facing preconditioner object of the port.

A thin counterpart of ``hifir_tpu.api.HIF``: it holds host levels (loaded
with :func:`load_prec`) and packs them onto a device with
:meth:`HIF.to_device`.
Factorization is not ported yet.
"""

from __future__ import annotations

from typing import List

from .alg.level import LevelPrec
from .alg.prec import DevicePrec
from .utils.serialize import load_prec, prec_from_arrays

__all__ = ["HIF", "load_prec", "prec_from_arrays"]


class HIF:
    """Multilevel preconditioner held on host."""

    def __init__(self, precs: List[LevelPrec] = ()):
        self.precs = list(precs)

    def nnz(self) -> int:
        return sum(p.nnz() for p in self.precs)

    def to_device(self, dtype=None, device="cuda",
                  dense_inv="auto") -> DevicePrec:
        """Pack onto ``device`` for the batched M-solve."""
        return DevicePrec.from_host(self.precs, dtype=dtype, device=device,
                                    dense_inv=dense_inv)
