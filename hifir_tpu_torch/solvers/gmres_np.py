"""Host Krylov drivers: right-preconditioned GMRES(m) and FGMRES-HIFIR.

The port's copy of ``hifir_tpu/solvers/gmres_np.py``.  The reference ships
these as examples (``examples/advanced/gmres.hpp:18-122`` gmres_hif,
``:127-231`` fgmres_hifir with adaptive inner refinement
``nirs = 2^outer``); the JAX package promotes them to library code.  ``A``
is a host CSR (or anything with ``matvec``) and ``M`` a host
:class:`~hifir_tpu_torch.api.HIF`.  The device drivers, which take a
:class:`~hifir_tpu_torch.alg.prec.DevicePrec`, are
:mod:`hifir_tpu_torch.solvers.gmres`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["gmres_hif", "fgmres_hifir"]


def _givens(a, b):
    """Complex-safe Givens rotation zeroing b: returns (c, s) with c real,
    such that [conj(c) conj(s); -s c] ... applied as
    t = c*a + s*b; b' = -conj(s)*a + conj(c)*b = 0."""
    r = np.hypot(abs(a), abs(b))
    if r == 0.0:
        return 1.0, 0.0
    if not np.iscomplexobj(np.asarray(a)) and not np.iscomplexobj(np.asarray(b)):
        return a / r, b / r
    return np.conj(a) / r, np.conj(b) / r


def gmres_hif(A, M, b: np.ndarray, restart: int = 30, rtol: float = 1e-6,
              maxit: int = 500, x0: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, int, int]:
    """Right-preconditioned restarted GMRES.

    Returns ``(x, flag, iters)`` with flag 0 on convergence (relative residual
    ``||b - A x|| / ||b|| <= rtol``), 1 otherwise.
    """
    n = b.shape[0]
    dt = np.result_type(b.dtype, np.float64)
    x = np.zeros(n, dtype=dt) if x0 is None else np.array(x0, dtype=dt)
    bnrm = np.linalg.norm(b)
    if bnrm == 0.0:
        return x, 0, 0
    it = 0
    for _outer in range(maxit):
        r = b - A.matvec(x) if it or x0 is not None else b.astype(dt)
        beta = np.linalg.norm(r)
        if beta / bnrm <= rtol:
            return x, 0, it
        m = restart
        V = np.zeros((m + 1, n), dtype=dt)
        H = np.zeros((m + 1, m), dtype=dt)
        cs = np.zeros(m, dtype=dt)
        sn = np.zeros(m, dtype=dt)
        g = np.zeros(m + 1, dtype=dt)
        g[0] = beta
        V[0] = r / beta
        j = 0
        while j < m and it < maxit:
            w = A.matvec(M.solve(V[j]))
            # modified Gram-Schmidt
            for i in range(j + 1):
                H[i, j] = np.vdot(V[i], w)
                w -= H[i, j] * V[i]
            H[j + 1, j] = np.linalg.norm(w)
            if H[j + 1, j] > 0:
                V[j + 1] = w / H[j + 1, j]
            # apply stored rotations
            for i in range(j):
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = (-np.conj(sn[i]) * H[i, j]
                               + np.conj(cs[i]) * H[i + 1, j])
                H[i, j] = t
            cs[j], sn[j] = _givens(H[j, j], H[j + 1, j])
            H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
            H[j + 1, j] = 0.0
            g[j + 1] = -np.conj(sn[j]) * g[j]
            g[j] = cs[j] * g[j]
            it += 1
            j += 1
            if abs(g[j]) / bnrm <= rtol:
                break
        # back substitution
        y = np.linalg.solve(np.triu(H[:j, :j]), g[:j])
        x = x + M.solve(V[:j].T @ y)
        if abs(g[j]) / bnrm <= rtol:
            return x, 0, it
    return x, 1, it


def fgmres_hifir(A, M, b: np.ndarray, restart: int = 30, rtol: float = 1e-6,
                 maxit: int = 500, x0: Optional[np.ndarray] = None,
                 rank: int = 0
                 ) -> Tuple[np.ndarray, int, int, int]:
    """Flexible GMRES with adaptive inner HIFIR refinement.

    The inner refinement count doubles with the outer iteration
    (``nirs = 2^outer``, ref ``gmres.hpp:164``).  Returns
    ``(x, flag, iters, n_matvec)``.
    """
    n = b.shape[0]
    x = np.zeros(n) if x0 is None else np.array(x0, dtype=float)
    bnrm = np.linalg.norm(b)
    if bnrm == 0.0:
        return x, 0, 0, 0
    it = 0
    nmv = 0
    for outer in range(maxit):
        r = b - A.matvec(x) if it or x0 is not None else b.copy()
        if it or x0 is not None:
            nmv += 1
        beta = np.linalg.norm(r)
        if beta / bnrm <= rtol:
            return x, 0, it, nmv
        m = restart
        V = np.zeros((m + 1, n))
        Z = np.zeros((m, n))
        H = np.zeros((m + 1, m))
        cs = np.zeros(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        V[0] = r / beta
        j = 0
        while j < m and it < maxit:
            nirs = 1 << min(it, 30)
            if nirs <= 1:
                z = M.solve(V[j], r=rank)
            else:
                z = M.hifir(A, V[j], nirs, r=rank)
            Z[j] = z
            w = A.matvec(z)
            nmv += 1
            for i in range(j + 1):
                H[i, j] = np.vdot(V[i], w)
                w -= H[i, j] * V[i]
            H[j + 1, j] = np.linalg.norm(w)
            if H[j + 1, j] > 0:
                V[j + 1] = w / H[j + 1, j]
            for i in range(j):
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -sn[i] * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            cs[j], sn[j] = _givens(H[j, j], H[j + 1, j])
            H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
            H[j + 1, j] = 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            it += 1
            j += 1
            if abs(g[j]) / bnrm <= rtol:
                break
        y = np.linalg.solve(np.triu(H[:j, :j]), g[:j])
        x = x + Z[:j].T @ y
        if abs(g[j]) / bnrm <= rtol:
            return x, 0, it, nmv
    return x, 1, it, nmv
