"""HIFIR: iterative refinement around the multilevel M-solve.

The port of ``hifir_tpu/solvers/gmres.py:ir_apply_device``.  The operator A
may be a sliced ELL, an ELL or a BSR (:mod:`..ops.spmv`,
:mod:`..ops.bsr_spmv`); the residual B - A X runs in kernel K1 with its
fused epilogue, or in K7 followed by a subtraction, on the card.
"""

from __future__ import annotations

import torch

from ..ops.spmv import ell_matvec_mrhs, sliced_ell_sub_mrhs

__all__ = ["ir_apply"]


def ir_apply(A, prec, b, nirs: int) -> torch.Tensor:
    """x = HIFIR(b): x = M^{-1} b, then nirs - 1 steps of x += M^{-1}(b - A x).

    ``b`` is one vector (n,) or a block (n, nrhs); ``prec`` a
    :class:`~hifir_tpu_torch.alg.prec.DevicePrec`, whose dtype and device the
    result takes.
    """
    b = torch.as_tensor(b, dtype=prec.dtype, device=prec.device)
    B = b[:, None] if b.ndim == 1 else b
    X = prec.solve_mrhs(B)
    for _ in range(1, nirs):
        if hasattr(A, "block_cols"):   # BSR: K7, then the subtraction
            R = B - ell_matvec_mrhs(A, X)
        else:                          # (sliced) ELL: K1's fused B - A X
            R = sliced_ell_sub_mrhs(A, X, B)
        X = X + prec.solve_mrhs(R)
    return X[:, 0] if b.ndim == 1 else X
