"""User-facing preconditioner object of the port.

A thin counterpart of ``hifir_tpu.api.HIF``: it holds host levels (loaded
with :func:`load_prec`) and packs them onto a device with
:meth:`HIF.to_device`; the pack's ``pack_transpose``, ``pack_prod`` and
``pack_prod_tran`` take ``HIF.precs``.  The GMRES drivers and the
null-space filter are exported here too.  Factorization is not ported yet.
"""

from __future__ import annotations

from typing import List

from .alg.level import LevelPrec
from .alg.prec import DevicePrec
from .nsp import NspFilter
from .solvers.gmres import fgmres_hifir, gmres_hif, gmres_mrhs
from .utils.serialize import load_prec, prec_from_arrays

__all__ = ["HIF", "load_prec", "prec_from_arrays", "NspFilter", "gmres_hif",
           "fgmres_hifir", "gmres_mrhs"]


class HIF:
    """Multilevel preconditioner held on host."""

    def __init__(self, precs: List[LevelPrec] = ()):
        self.precs = list(precs)

    def nnz(self) -> int:
        return sum(p.nnz() for p in self.precs)

    def to_device(self, dtype=None, device="cuda",
                  dense_inv="auto") -> DevicePrec:
        """Pack onto ``device`` for the batched M-solve; ``dtype`` is
        np.float32, np.float64, np.complex64, np.complex128 or None (the
        host's own: complex128 for a complex factorization)."""
        return DevicePrec.from_host(self.precs, dtype=dtype, device=device,
                                    dense_inv=dense_inv)
