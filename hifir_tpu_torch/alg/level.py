"""Host data of one level of the multilevel preconditioner.

Mirrors ``hifir_tpu/alg/factor.py:LevelPrec`` field for field, so that a
preconditioner saved by the JAX package loads here unchanged and the port's
own factorize (:mod:`.factor`) fills the same fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..ds.csr import CSR

__all__ = ["LevelPrec"]


@dataclasses.dataclass
class LevelPrec:
    """One level: scaled, permuted block LDU of the leading m rows, the
    E/F off blocks, and (last level only) the dense Schur complement
    (ref ``alg/Prec.hpp:82``)."""

    m: int
    n: int
    L_B: CSR
    d: np.ndarray
    U_B: CSR
    E: CSR                     # (n-m) x m block of scaled permuted A
    F: CSR                     # m x (n-m) block of scaled permuted A
    s: np.ndarray
    t: np.ndarray
    p: np.ndarray              # row permutation (position -> original row)
    p_inv: np.ndarray
    q: np.ndarray
    q_inv: np.ndarray
    dense_matrix: Optional[np.ndarray] = None   # last-level dense Schur
    dense_solver: Optional[object] = None
    symm: bool = False

    @property
    def is_last_level(self) -> bool:
        return self.dense_matrix is not None or self.m == self.n

    def nnz(self) -> int:
        z = self.nnz_ldu() + self.nnz_ef()
        if self.dense_matrix is not None:
            z += self.dense_matrix.size
        return z

    def nnz_ef(self) -> int:
        return self.E.nnz + self.F.nnz

    def nnz_ldu(self) -> int:
        return self.L_B.nnz + self.U_B.nnz + self.m

    def astype(self, dtype) -> "LevelPrec":
        """Cast the numeric payload (single-precision storage, the analog of
        the reference's HIF<float> instantiation)."""
        out = dataclasses.replace(
            self,
            L_B=self.L_B.astype(dtype), U_B=self.U_B.astype(dtype),
            E=self.E.astype(dtype), F=self.F.astype(dtype),
            d=self.d.astype(dtype), s=self.s.astype(dtype),
            t=self.t.astype(dtype))
        if out.dense_matrix is not None:
            out.dense_matrix = out.dense_matrix.astype(dtype)
        return out
