"""Krylov drivers on the device: GMRES(m), FGMRES-HIFIR and batched GMRES.

The port of ``hifir_tpu/solvers/gmres.py``: right-preconditioned restarted
GMRES around the multilevel M-solve (:func:`gmres_hif`), flexible GMRES with
inner iterative refinement and a rank control (:func:`fgmres_hifir`), and
GMRES over a block of right-hand sides (:func:`gmres_mrhs`).  The operator A
may be an ELL or a sliced ELL (kernel K1) or a BSR (kernel K7).

The iteration is the JAX package's: CGS2 as two projections, Givens
rotations of each new Hessenberg column, the early exit of a single-RHS
cycle once |g[j+1]| <= rtol ||b||, and, in the batched cycle, all m steps
with a breakdown mask per column.  The vectors live on the pack's device:
the basis V, the preconditioned Z, the M-solves, the A-products and the
CGS2 projections (``torch.matmul``/``torch.bmm``, outside any hand kernel,
as in the JAX package).  The Hessenberg columns, the rotations and the
final m x m back-substitution run on the host, in numpy, in the working
dtype.  So a single-RHS Arnoldi step syncs the host once (its Hessenberg
column and norm come back to decide the early exit), and a batched cycle
syncs once, when its Hessenberg matrices come back after the last step.

Complex packs run the same iteration: the projections conjugate the basis,
the norms are real, and :func:`_givens` makes unitary rotations in both
drivers.  The JAX package's single-RHS rotation
(``hifir_tpu/solvers/gmres.py:93-101``) does not conjugate, so on complex
input its |g[j+1]| is not the residual norm and its iteration counts differ
from these; its batched cycle conjugates, as this one does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg as sla
import torch

from ..alg.prec import prec_solve_mrhs
from ..device import as_values, numpy_dtype
from ..ops.spmv import ell_matvec, ell_matvec_mrhs
from .ir import ir_apply, residual_mrhs

__all__ = ["gmres_hif", "fgmres_hifir", "gmres_mrhs"]


def _givens(c: np.ndarray, cs: np.ndarray, sn: np.ndarray, g: np.ndarray,
            j: int) -> None:
    """Rotate Hessenberg column ``j`` (``c``: (m+1, R), one column per
    right-hand side) by the stored rotations, make its own rotation and
    apply that to ``g``, all in place."""
    for i in range(j):
        t = cs[i] * c[i] + sn[i] * c[i + 1]
        c[i + 1] = -np.conj(sn[i]) * c[i] + np.conj(cs[i]) * c[i + 1]
        c[i] = t
    a, bb = c[j].copy(), c[j + 1].copy()
    rho = np.sqrt(np.abs(a) ** 2 + np.abs(bb) ** 2)
    ok = rho > 0
    safe = np.where(ok, rho, 1)
    cs[j] = np.where(ok, np.conj(a) / safe, 1)
    sn[j] = np.where(ok, np.conj(bb) / safe, 0)
    c[j] = rho
    c[j + 1] = 0
    g[j + 1] = -np.conj(sn[j]) * g[j]
    g[j] = cs[j] * g[j]


def _restart_cycle(A, msolve, b: torch.Tensor, x: torch.Tensor,
                   rtol_bnrm: float, m: int):
    """One GMRES(m) restart cycle; returns (x_new, |residual| estimate,
    steps done)."""
    n = b.shape[0]
    ndt = numpy_dtype(b.dtype)
    r = residual_mrhs(A, b[:, None], x[:, None])[:, 0]
    beta = float(torch.linalg.vector_norm(r))
    V = b.new_zeros((m + 1, n))
    Z = b.new_zeros((m, n))
    V[0] = r / beta if beta > 0 else r
    H = np.zeros((m + 1, m), ndt)
    cs, sn = np.zeros((m, 1), ndt), np.zeros((m, 1), ndt)
    g = np.zeros((m + 1, 1), ndt)
    g[0] = beta
    j_used = m
    for j in range(m):
        z = msolve(V[j])
        w = ell_matvec(A, z)
        Vj = V[:j + 1]
        h1 = Vj.conj() @ w
        w = w - h1 @ Vj
        h2 = Vj.conj() @ w
        w = w - h2 @ Vj
        nrm = torch.linalg.vector_norm(w)[None].to(w.dtype)
        col = torch.cat([h1 + h2, nrm]).cpu().numpy()
        hj1 = float(col[-1].real)   # the norm, real in every dtype
        V[j + 1] = w / hj1 if hj1 > 0 else w
        Z[j] = z
        c = np.zeros((m + 1, 1), ndt)
        c[:j + 2, 0] = col
        _givens(c, cs, sn, g, j)
        H[:, j] = c[:, 0]
        if abs(g[j + 1, 0]) <= rtol_bnrm:
            j_used = j + 1
            break
    y = sla.solve_triangular(H[:j_used, :j_used], g[:j_used, 0])
    x_new = x + torch.as_tensor(y, device=x.device) @ Z[:j_used]
    return x_new, float(abs(g[j_used, 0])), j_used


def _gmres(A, msolve_of, prec, b, restart, rtol, maxit, x0):
    """The restart loop shared by :func:`gmres_hif` and
    :func:`fgmres_hifir`; ``msolve_of(cycle)`` is the preconditioner of a
    cycle."""
    b = as_values(b, prec.dtype, prec.device)
    bnrm = float(torch.linalg.vector_norm(b))
    if bnrm == 0.0:
        return torch.zeros_like(b), 0, 0
    x = (torch.zeros_like(b) if x0 is None
         else as_values(x0, prec.dtype, prec.device))
    it, flag, cycle = 0, 1, 0
    while it < maxit:
        x, res, j_used = _restart_cycle(A, msolve_of(cycle), b, x,
                                        rtol * bnrm, restart)
        it += j_used
        cycle += 1
        if res <= rtol * bnrm:
            flag = 0
            break
    return x, flag, it


def gmres_hif(A, prec, b, restart: int = 30, rtol: float = 1e-6,
              maxit: int = 500, x0=None) -> Tuple[torch.Tensor, int, int]:
    """Right-preconditioned restarted GMRES on the pack's device.

    ``A`` is an ELL, sliced-ELL or BSR operator, ``prec`` a
    :class:`~hifir_tpu_torch.alg.prec.DevicePrec`.  Returns (x, flag,
    iterations); flag 0 means converged to ``rtol``."""
    return _gmres(A, lambda cycle: lambda v: ir_apply(A, prec, v, 1), prec,
                  b, restart, rtol, maxit, x0)


def fgmres_hifir(A, prec, b, restart: int = 30, rtol: float = 1e-6,
                 maxit: int = 500, x0=None, max_inner: int = 4,
                 rank: int = 0) -> Tuple[torch.Tensor, int, int]:
    """Flexible GMRES whose preconditioner is HIFIR (:func:`ir_apply`).

    The inner refinement count doubles once per restart cycle (1, 2, 4, ...,
    capped at ``2**max_inner``), as in the JAX package; ``rank > 0``
    overrides the dense tail's rank in every M-solve.  Returns (x, flag,
    iterations)."""
    def msolve_of(cycle):
        nirs = 1 << min(cycle, max_inner)
        return lambda v: ir_apply(A, prec, v, nirs, r=rank)

    return _gmres(A, msolve_of, prec, b, restart, rtol, maxit, x0)


def _restart_cycle_mrhs(A, prec, B: torch.Tensor, X: torch.Tensor, m: int):
    """One batched GMRES(m) restart cycle over the R columns of B: all m
    steps; returns (X_new, |residual| estimates (R,)).

    The basis of column k is V[k] (rows are vectors), so each projection is
    one strided-batched GEMM over the columns.  The JAX layout (m+1, n, R)
    puts the batch innermost, where ``torch.bmm`` and ``torch.einsum`` would
    copy the basis for every projection; this one costs a transposed copy of
    the (n, R) A-product a step instead.  The M-solve reads V[:, j].T as it
    is: its first gather by p writes a contiguous block."""
    n, R = B.shape
    ndt = numpy_dtype(B.dtype)
    Rsd = residual_mrhs(A, B, X)
    beta = torch.linalg.vector_norm(Rsd, dim=0)                    # (R,)
    V = B.new_zeros((R, m + 1, n))
    Z = B.new_zeros((R, m, n))
    Hd = B.new_zeros((R, m + 1, m))
    V[:, 0] = (Rsd / torch.where(beta > 0, beta, 1)).T
    for j in range(m):
        Zj = prec_solve_mrhs(prec.levels, prec.tail, V[:, j].T)
        Z[:, j] = Zj.T
        W = ell_matvec_mrhs(A, Zj).T.contiguous()[:, None]         # (R, 1, n)
        Vj = V[:, :j + 1]                                          # (R, j+1, n)
        h1 = torch.bmm(W, Vj.mH)                                   # (R, 1, j+1)
        W = torch.baddbmm(W, h1, Vj, alpha=-1)
        h2 = torch.bmm(W, Vj.mH)
        W = torch.baddbmm(W, h2, Vj, alpha=-1)
        hj1 = torch.linalg.vector_norm(W[:, 0], dim=1)       # (R,), real
        Hd[:, :j + 1, j] = (h1 + h2)[:, 0]
        Hd[:, j + 1, j] = hj1
        # a zero W (breakdown) stays zero
        torch.div(W[:, 0], torch.where(hj1 > 0, hj1, 1)[:, None],
                  out=V[:, j + 1])
    H = Hd.cpu().numpy()
    cs, sn = np.zeros((m, R), ndt), np.zeros((m, R), ndt)
    g = np.zeros((m + 1, R), ndt)
    g[0] = beta.cpu().numpy()
    Hr = np.zeros((m + 1, m, R), ndt)
    for j in range(m):
        c = np.ascontiguousarray(H[:, :, j].T)                     # (m+1, R)
        _givens(c, cs, sn, g, j)
        Hr[:, j] = c
    # per column, the steps before the first zero pivot (a Krylov breakdown,
    # which is exact convergence) enter the back-substitution
    y = np.zeros((R, m), ndt)
    used = np.cumprod(np.abs(np.diagonal(Hr[:m, :m], axis1=0, axis2=1)) > 0,
                      axis=1).sum(axis=1)                          # (R,)
    for k in range(R):
        jk = int(used[k])
        if jk:
            y[k, :jk] = sla.solve_triangular(Hr[:jk, :jk, k], g[:jk, k])
    Yd = torch.as_tensor(y, device=X.device)
    X_new = X + torch.bmm(Yd[:, None, :], Z)[:, 0].T
    return X_new, np.abs(g[m])


def gmres_mrhs(A, prec, B, restart: int = 30, rtol: float = 1e-6,
               maxit: int = 500) -> Tuple[torch.Tensor, int, int]:
    """Right-preconditioned restarted GMRES over the columns of B (n, R),
    every kernel launch shared by all columns (the M-solve is the batched
    one).  Returns (X, flag, cycles); flag 0 once every column's residual
    estimate is within ``rtol`` of its ||b||."""
    B = as_values(B, prec.dtype, prec.device)
    bnrm = torch.linalg.vector_norm(B, dim=0).cpu().numpy()
    bsafe = np.where(bnrm > 0, bnrm, 1)
    X = torch.zeros_like(B)
    cycles, flag = 0, 1
    while cycles * restart < maxit:
        X, res = _restart_cycle_mrhs(A, prec, B, X, restart)
        cycles += 1
        if float(np.max(res / bsafe)) <= rtol:
            flag = 0
            break
    return X, flag, cycles
