"""A-priori scaling (ref ``src/hif/pre/a_priori_scaling.hpp``): the port's
copy of ``hifir_tpu/pre/scaling.py``.

Vectorized numpy implementations of the three pre-scaling modes selected by
``Options.pre_scale`` (ref ``pre/EqlDriver.hpp:82-92``): identity, extreme-value
scaling, and Jacobi-style iterative equilibration.  These run on host once per
level; they are cheap O(nnz) passes.
"""

from __future__ import annotations

import numpy as np

from ..ds.csr import CSR

__all__ = ["scale_eye", "scale_extreme_values", "iterative_scale"]


def _row_abs_max(A: CSR) -> np.ndarray:
    out = np.zeros(A.nrows)
    rows = np.repeat(np.arange(A.nrows), A.row_nnz())
    np.maximum.at(out, rows, np.abs(A.data))
    return out


def _col_abs_max(A: CSR) -> np.ndarray:
    out = np.zeros(A.ncols)
    np.maximum.at(out, A.indices, np.abs(A.data))
    return out


def scale_eye(A: CSR):
    """No-op scaling (ref ``a_priori_scaling.hpp:57``)."""
    return A, np.ones(A.nrows), np.ones(A.ncols)


def scale_extreme_values(A: CSR, is_symm: bool = False):
    """Scale by inverse sqrt of row/col extreme magnitudes
    (ref ``a_priori_scaling.hpp:87``)."""
    rmax = _row_abs_max(A)
    rmax[rmax == 0.0] = 1.0
    s = 1.0 / np.sqrt(rmax)
    if is_symm:
        t = s.copy()
    else:
        B = A.scale_diag_left(s)
        cmax = _col_abs_max(B)
        cmax[cmax == 0.0] = 1.0
        t = 1.0 / cmax
    out = A.scale_diag_left(s).scale_diag_right(t)
    return out, s, t


def iterative_scale(A: CSR, tol: float = 1e-10, max_iters: int = 5,
                    is_symm: bool = False):
    """Jacobi/Ruiz-style iterative equilibration in sup-norm
    (ref ``a_priori_scaling.hpp:163,273``)."""
    s = np.ones(A.nrows)
    t = np.ones(A.ncols)
    B = A
    for _ in range(max_iters):
        rmax = _row_abs_max(B)
        cmax = _col_abs_max(B)
        rmax[rmax == 0.0] = 1.0
        cmax[cmax == 0.0] = 1.0
        if (np.abs(1.0 - rmax).max() <= tol and
                np.abs(1.0 - cmax).max() <= tol):
            break
        dr = 1.0 / np.sqrt(rmax)
        dc = 1.0 / np.sqrt(cmax)
        if is_symm:
            dr = dc = np.sqrt(dr * dc)
        s *= dr
        t *= dc
        B = B.scale_diag_left(dr).scale_diag_right(dc)
    return B, s, t
