"""Host (numpy) multilevel preconditioner apply.

Mirrors ``src/hif/alg/prec_solve.hpp:333`` (``prec_solve``), ``:542``
(transpose) and ``alg/prec_prod.hpp`` (forward product): the port's copy of
``hifir_tpu/alg/prec_solve_np.py``.  It works on the host ``LevelPrec``
list; the triangular solves run in the native host library for real f32/f64
factors (:meth:`~hifir_tpu_torch.ds.csr.CSR.solve_as_strict_lower`).  The
device version is :mod:`hifir_tpu_torch.alg.prec`.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .level import LevelPrec

__all__ = ["prec_solve_np", "prec_prod_np", "prec_prod_tran_np"]


def _ldu_solve(prec: LevelPrec, y: np.ndarray) -> np.ndarray:
    """y <- U^{-1} D^{-1} L^{-1} y (ref ``prec_solve_ldu``,
    prec_solve.hpp:205)."""
    y = prec.L_B.solve_as_strict_lower(y)
    y = y / (prec.d[:, None] if y.ndim == 2 else prec.d)
    return prec.U_B.solve_as_strict_upper(y)


def _ldu_solve_tran(prec: LevelPrec, y: np.ndarray) -> np.ndarray:
    """y <- L^{-H} D^{-H} U^{-H} y (ref ``prec_solve_utdlt``,
    prec_solve.hpp:285): U^H is unit strict lower, L^H unit strict upper."""
    UH = prec.U_B.transpose()
    UH.data = np.conj(UH.data)
    LH = prec.L_B.transpose()
    LH.data = np.conj(LH.data)
    y = UH.solve_as_strict_lower(y)
    dc = np.conj(prec.d)
    y = y / (dc[:, None] if y.ndim == 2 else dc)
    return LH.solve_as_strict_upper(y)


def _bc(v: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Broadcast a length-n scaling vector over a (n,) or (n, k) operand."""
    return v[:, None] if b.ndim == 2 else v


def prec_solve_np(precs: List[LevelPrec], b: np.ndarray, last_dim: int = 0,
                  level: int = 0, trans: bool = False) -> np.ndarray:
    """Multilevel M-solve; returns x = M^{-1} b (or M^{-H} b).

    ``b`` may be (n,) or an (n, k) multi-RHS block — the batched path maps
    to the reference's ``prec_solve_mrhs`` (prec_solve.hpp:428) with runtime
    k instead of compile-time Nrhs.
    """
    if trans:
        return _prec_solve_tran(precs, np.asarray(b), last_dim, level)
    prec = precs[level]
    m, n = prec.m, prec.n
    nm = n - m
    b = np.asarray(b)
    wb = _bc(prec.s[prec.p], b) * b[prec.p]

    y_tail = wb[:0]
    x1 = wb[:m].copy()
    if nm:
        x1 = _ldu_solve(prec, x1)
        y_tail = wb[m:] - prec.E.matvec(x1)
        if prec.is_last_level:
            if prec.dense_solver is not None:
                y_tail = prec.dense_solver.solve(y_tail, last_dim)
        else:
            y_tail = prec_solve_np(precs, y_tail, last_dim, level + 1)
        x1 = wb[:m] - prec.F.matvec(y_tail)
    x1 = _ldu_solve(prec, x1)
    sol = np.concatenate([x1, y_tail])
    return _bc(prec.t, b) * sol[prec.q_inv]


def _prec_solve_tran(precs: List[LevelPrec], b: np.ndarray, last_dim: int,
                     level: int) -> np.ndarray:
    """Transpose/Hermitian multilevel solve (ref prec_solve.hpp:542).

    The forward map is x = T Q Z^{-1} P S b with Z the level block operator;
    the adjoint is x = S P^T Z^{-H} Q^T T b mirrored level by level.
    """
    prec = precs[level]
    m, n = prec.m, prec.n
    nm = n - m
    # adjoint of the output stage (y = t * sol[q_inv]): w[pos] = conj(t[q[pos]])*b[q[pos]]
    b = np.asarray(b)
    wb = _bc(np.conj(prec.t[prec.q]), b) * b[prec.q]

    y_tail = wb[:0]
    x1 = wb[:m].copy()
    if nm:
        # mirror of the forward recursion with E and F swapped (adjoint):
        # z2 = M_next^{-H}(w2 - F^H Bhat^{-H} w1); z1 = Bhat^{-H}(w1 - E^H z2)
        x1 = _ldu_solve_tran(prec, x1)
        y_tail = wb[m:] - prec.F.matvec_tran(x1, conj=True)
        if prec.is_last_level:
            if prec.dense_solver is not None:
                y_tail = prec.dense_solver.solve(y_tail, last_dim, trans=True)
        else:
            y_tail = _prec_solve_tran(precs, y_tail, last_dim, level + 1)
        x1 = wb[:m] - prec.E.matvec_tran(y_tail, conj=True)
    x1 = _ldu_solve_tran(prec, x1)
    sol = np.concatenate([x1, y_tail])
    # adjoint of the input stage (wb = s[p]*b[p]): out[p[i]] = conj(s[p[i]])*sol[i]
    out = np.zeros(sol.shape, dtype=sol.dtype)
    out[prec.p] = _bc(np.conj(prec.s[prec.p]), sol) * sol
    return out


def prec_prod_np(precs: List[LevelPrec], x: np.ndarray, last_dim: int = 0,
                 level: int = 0) -> np.ndarray:
    """Forward product y = M x (ref ``alg/prec_prod.hpp:54``)."""
    prec = precs[level]
    m, n = prec.m, prec.n
    nm = n - m
    v = np.asarray(x)[prec.q] / prec.t[prec.q]
    v1, v2 = v[:m], v[m:]

    def bhat(z):
        # (I+L) D (I+U) z
        z = z + prec.U_B.matvec(z)
        z = prec.d * z
        return z + prec.L_B.matvec(z)

    if nm:
        # u2 = E (v1 + Bhat^{-1} F v2) + M_next v2
        Fv2 = prec.F.matvec(v2)
        w = v1 + _ldu_solve(prec, Fv2.copy())
        if prec.is_last_level:
            mv2 = (prec.dense_solver.multiply(v2)
                   if prec.dense_solver is not None else v2)
        else:
            mv2 = prec_prod_np(precs, v2, last_dim, level + 1)
        u2 = prec.E.matvec(w) + mv2
        u1 = bhat(v1) + Fv2
        u = np.concatenate([u1, u2])
    else:
        u = bhat(v1)
    y = np.empty(n, dtype=u.dtype)
    y[prec.p] = u / prec.s[prec.p]
    return y


def prec_prod_tran_np(precs: List[LevelPrec], x: np.ndarray, last_dim: int = 0,
                      level: int = 0) -> np.ndarray:
    """Adjoint forward product y = M^H x (ref ``prec_prod_tran``,
    alg/prec_prod.hpp).

    With M = S^{-1} P^T Z Q^T T^{-1} and Z the level block operator, the
    adjoint is M^H = T^{-H} Q Z^H P S^{-H}, applied level by level with E/F
    swapped and the LDU factors conjugate-transposed.
    """
    prec = precs[level]
    m, n = prec.m, prec.n
    nm = n - m
    conj = np.conj
    w = np.asarray(x)[prec.p] / conj(prec.s[prec.p])
    w1, w2 = w[:m], w[m:]

    def bhat_h(z):
        # (I + U^H) conj(D) (I + L^H) z
        z = z + prec.L_B.matvec_tran(z, conj=np.iscomplexobj(prec.L_B.data))
        z = conj(prec.d) * z
        return z + prec.U_B.matvec_tran(z, conj=np.iscomplexobj(prec.U_B.data))

    if nm:
        cplx = np.iscomplexobj(prec.E.data)
        EHw2 = prec.E.matvec_tran(w2, conj=cplx)
        u = w1 + _ldu_solve_tran(prec, EHw2)
        if prec.is_last_level:
            mnext = (prec.dense_solver.multiply(w2, trans=True)
                     if prec.dense_solver is not None else w2)
        else:
            mnext = prec_prod_tran_np(precs, w2, last_dim, level + 1)
        z2 = prec.F.matvec_tran(u, conj=cplx) + mnext
        z1 = bhat_h(w1) + EHw2
        z = np.concatenate([z1, z2])
    else:
        z = bhat_h(w1)
    y = np.zeros(n, dtype=z.dtype)
    y[prec.q] = z / conj(prec.t[prec.q])
    return y
