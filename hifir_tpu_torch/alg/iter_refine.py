"""Iterative refinement (the "IR" in HIFIR).

The port's copy of ``hifir_tpu/alg/iter_refine.py``, on the host.

Ref ``src/hif/alg/IterRefine.hpp:45-190``: stationary iteration
``x_{k+1} = x_k + M^{-1}(b - A x_k)`` with an optional residual-bounded variant
returning (iterations, flag): flag 0 converged (``||r||/||b|| <= beta[0]``),
>0 diverged (``> beta[1]``), <0 hit the iteration cap.

Boosted precision (the reference's ``HIF_HIGH_PRECISION_SOLVE``,
``macros.hpp:55-58`` + ``utils/common.hpp:219-246`` ``boost_type``: double ->
long double): with ``boost=True`` the solution and the residual accumulate in
``np.longdouble``.  For a host CSR operand the residual matvec itself runs in
long double (scipy's sparsetools are templated over ``npy_longdouble``), which
is exactly the reference's boosted ``mt::mv_nt`` on boost-typed work arrays;
only the preconditioner correction solve stays in working f64 precision
(matching ``builder.hpp:125-131``, which boosts the IterRefine work arrays
and nothing inside M).  For user mat-vec callbacks — which only speak the
working precision — the residual falls back to a hi/lo split of x (two f64
matvecs summed in long double), recovering the error of x's low half but not
the f64 kernel's own rounding.  Off by default, like the reference macro.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["iter_refine"]


def iter_refine(M, A, b: np.ndarray, N: int,
                betas: Optional[Tuple[float, float]] = None,
                trans: bool = False, r: int = 0, boost: bool = False
                ) -> Tuple[np.ndarray, int, int]:
    """Run up to N refinement steps; returns ``(x, iters, flag)``.

    ``A`` may be a host CSR matrix or any callable ``x -> A x`` (the reference
    accepts user mat-vec callbacks, ``builder.hpp:462-463``).  ``boost``
    accumulates x and the residual in extended precision (long double),
    mirroring ``HIF_HIGH_PRECISION_SOLVE``.
    """
    matvec: Callable[[np.ndarray], np.ndarray]
    if callable(A) and not hasattr(A, "matvec"):
        matvec = A
    elif trans:
        matvec = lambda v: A.matvec_tran(v, conj=np.iscomplexobj(A.data))
    else:
        matvec = A.matvec

    b = np.asarray(b)
    if boost and b.dtype in (np.float64, np.complex128):
        matvec_ld = None
        if hasattr(A, "to_scipy"):
            # true boosted residual: the matvec runs in long double
            ldt = np.clongdouble if np.iscomplexobj(b) else np.longdouble
            S = A.to_scipy().astype(ldt)
            if trans:
                S = S.conj().T.tocsr() if np.iscomplexobj(b) else S.T.tocsr()
            matvec_ld = lambda v: S @ v
        return _iter_refine_boost(M, matvec, matvec_ld, b, N, betas,
                                  trans, r)
    x = np.zeros_like(b)
    beta_ok = betas is not None
    nrm_b = float(np.linalg.norm(b)) if beta_ok else 0.0
    flag = -1
    it = 0
    res = b
    for it in range(1, N + 1):
        if it > 1:
            res = b - matvec(x)
        x = x + M.solve(res, trans=trans, r=r)
        if beta_ok:
            res_new = b - matvec(x)
            rel = float(np.linalg.norm(res_new)) / max(nrm_b, 1e-300)
            if rel <= betas[0]:
                flag = 0
                break
            if rel > betas[1]:
                flag = 1
                break
    return x, it, flag


def _boost_matvec_split(matvec, xw: np.ndarray, wdt) -> np.ndarray:
    """A @ xw for a long-double xw via a hi/lo split (callback fallback):
    the f64 kernel runs twice and the partial products sum in long double —
    recovers x's low half, not the f64 kernel's own rounding."""
    x_hi = np.asarray(xw, dtype=wdt)
    x_lo = np.asarray(xw - x_hi, dtype=wdt)
    return (np.asarray(matvec(x_hi), dtype=xw.dtype)
            + np.asarray(matvec(x_lo), dtype=xw.dtype))


def _iter_refine_boost(M, matvec, matvec_ld, b: np.ndarray, N: int,
                       betas: Optional[Tuple[float, float]],
                       trans: bool, r: int
                       ) -> Tuple[np.ndarray, int, int]:
    cplx = np.iscomplexobj(b)
    ldt = np.clongdouble if cplx else np.longdouble
    wdt = np.complex128 if cplx else np.float64
    if matvec_ld is None:
        matvec_ld = lambda v: _boost_matvec_split(matvec, v, wdt)
    bw = np.asarray(b, dtype=ldt)
    xw = np.zeros_like(bw)
    beta_ok = betas is not None
    nrm_b = float(np.linalg.norm(bw.astype(wdt))) if beta_ok else 0.0
    flag = -1
    it = 0
    res = bw
    for it in range(1, N + 1):
        if it > 1:
            res = bw - matvec_ld(xw)
        # the correction solve stays in working precision (the reference
        # boosts only the IterRefine work arrays, builder.hpp:125-131)
        dx = M.solve(np.asarray(res, dtype=wdt), trans=trans, r=r)
        xw = xw + np.asarray(dx, dtype=ldt)
        if beta_ok:
            res_new = bw - matvec_ld(xw)
            rel = (float(np.linalg.norm(res_new.astype(wdt)))
                   / max(nrm_b, 1e-300))
            if rel <= betas[0]:
                flag = 0
                break
            if rel > betas[1]:
                flag = 1
                break
    return np.asarray(xw, dtype=wdt), it, flag
