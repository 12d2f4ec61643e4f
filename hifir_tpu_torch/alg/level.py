"""Host data of one level of the multilevel preconditioner.

Mirrors ``hifir_tpu/alg/factor.py:LevelPrec`` field for field, so that a
preconditioner saved by the JAX package loads here unchanged.
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
    E/F off blocks, and (last level only) the dense Schur complement."""

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

    def nnz(self) -> int:
        z = self.L_B.nnz + self.U_B.nnz + self.m + self.E.nnz + self.F.nnz
        if self.dense_matrix is not None:
            z += self.dense_matrix.size
        return z
