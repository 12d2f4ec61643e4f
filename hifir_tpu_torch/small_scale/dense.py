"""Factorization of the dense last level: LUP, rank-revealing QRCP, SYEIG.

The port's copy of ``hifir_tpu/small_scale/dense.py`` (scipy LAPACK:
``getrf``/``geqp3``/``syev``), and :class:`DeviceQRCP`, whose QRCP runs on
the GPU (K8, :mod:`.qrcp_device`).  The factors are plain arrays that
:class:`hifir_tpu_torch.alg.prec.DenseTail` moves to the device for the
device solve; ``solve`` and ``multiply`` are the host solve's
(:mod:`hifir_tpu_torch.alg.prec_solve_np`).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.linalg as sla

__all__ = ["QRCP", "DeviceQRCP", "LUP", "SYEIG", "DENSE_SOLVERS",
           "make_dense_solver", "solve_rank"]

_EPS = float(np.finfo(np.float64).eps)


def solve_rank(r, rank: int) -> int:
    """The rank a truncated solve keeps: ``r`` when 0 < r <= ``rank``, else
    ``rank`` (r <= 0, None and r above the factorization's rank all mean its
    own rank: the host QRCP's and SYEIG's rule)."""
    return int(r) if r is not None and 0 < r <= rank else int(rank)


class LUP:
    """Dense LU with partial pivoting."""

    kind = "lup"

    def __init__(self):
        self.lu = None
        self.piv = None
        self.rank = 0
        self.n = 0

    def factorize(self, M: np.ndarray, opts=None) -> None:
        self.n = M.shape[0]
        self.lu, self.piv = sla.lu_factor(M, check_finite=False)
        d = np.abs(np.diag(self.lu))
        if self.n and (d.min() <= _EPS * max(d.max(), 1.0)):
            warnings.warn("dense LU appears singular; consider QRCP")
        self.rank = self.n

    def solve(self, y: np.ndarray, rank: int = 0, trans: bool = False
              ) -> np.ndarray:
        return sla.lu_solve((self.lu, self.piv), y, trans=1 if trans else 0,
                            check_finite=False)

    def multiply(self, x: np.ndarray, trans: bool = False) -> np.ndarray:
        L = np.tril(self.lu, -1) + np.eye(self.n, dtype=self.lu.dtype)
        U = np.triu(self.lu)
        P = np.eye(self.n)[self.piv_perm()]
        M = P.T @ L @ U
        return (M.conj().T if trans else M) @ x

    def piv_perm(self) -> np.ndarray:
        """LAPACK's sequential row swaps as one permutation."""
        perm = np.arange(self.n)
        for i, pi in enumerate(self.piv):
            perm[i], perm[pi] = perm[pi], perm[i]
        return perm


class QRCP:
    """Rank-revealing QR with column pivoting.

    The rank is the last diagonal of R above ``|R_00| / rrqr_cond``, with
    ``rrqr_cond`` defaulting to ``eps^{-2/3}``.
    """

    kind = "qrcp"

    def __init__(self):
        self.Q = None
        self.R = None
        self.jpvt = None
        self.rank = 0
        self.n = 0

    def factorize(self, M: np.ndarray, opts=None) -> None:
        self.n = M.shape[0]
        if self.n == 0:
            self.rank = 0
            return
        Q, R, piv = sla.qr(M, pivoting=True, mode="economic",
                           check_finite=False)
        self.Q, self.R, self.jpvt = Q, R, piv
        rrqr_cond = getattr(opts, "rrqr_cond", 0.0) if opts is not None \
            else 0.0
        if rrqr_cond <= 0.0:
            rrqr_cond = _EPS ** (-2.0 / 3.0)
        d = np.abs(np.diag(R))
        if d.size == 0 or d[0] == 0.0:
            self.rank = 0
            return
        good = d > d[0] / rrqr_cond
        self.rank = int(np.flatnonzero(good)[-1] + 1) if good.any() else 0

    def solve(self, y: np.ndarray, rank: int = 0, trans: bool = False
              ) -> np.ndarray:
        """x = (Q R P^T)^{-1} y truncated to rank ``solve_rank(rank)``
        (``trans``: the adjoint); ``y`` may be (n,) or (n, k)."""
        r = solve_rank(rank, self.rank)
        shape = (self.n,) if y.ndim == 1 else (self.n, y.shape[1])
        x = np.zeros(shape, dtype=np.result_type(self.Q, y))
        if r == 0:
            return x
        if not trans:
            w = self.Q[:, :r].conj().T @ y
            z = sla.solve_triangular(self.R[:r, :r], w, check_finite=False)
            x[self.jpvt[:r]] = z
        else:
            w = y[self.jpvt[:r]]
            z = sla.solve_triangular(self.R[:r, :r], w, trans="C",
                                     check_finite=False)
            x = self.Q[:, :r] @ z
        return x

    def multiply(self, x: np.ndarray, trans: bool = False) -> np.ndarray:
        if not trans:
            return self.Q @ (self.R @ x[self.jpvt])
        y = np.zeros_like(x)
        y[self.jpvt] = self.R.conj().T @ (self.Q.conj().T @ x)
        return y


class SYEIG:
    """Symmetric eigen-decomposition with an ``n eps max|w|`` rank cut."""

    kind = "syeig"

    def __init__(self):
        self.V = None
        self.w = None
        self.rank = 0
        self.n = 0

    def factorize(self, M: np.ndarray, opts=None) -> None:
        self.n = M.shape[0]
        if self.n == 0:
            self.rank = 0
            return
        w, V = sla.eigh(0.5 * (M + M.conj().T), check_finite=False)
        self.w, self.V = w, V
        amax = np.abs(w).max() if w.size else 0.0
        self.rank = int((np.abs(w) > self.n * _EPS * amax).sum())

    def solve(self, y: np.ndarray, rank: int = 0, trans: bool = False
              ) -> np.ndarray:
        """The pseudo-inverse on the ``solve_rank(rank)`` eigenpairs of
        largest magnitude (Hermitian: ``trans`` changes nothing)."""
        r = solve_rank(rank, self.rank)
        if r == 0:
            return np.zeros_like(y)
        order = np.argsort(-np.abs(self.w))[:r]
        Vr = self.V[:, order]
        wr = self.w[order] if y.ndim == 1 else self.w[order][:, None]
        return Vr @ ((Vr.conj().T @ y) / wr)

    def multiply(self, x: np.ndarray, trans: bool = False) -> np.ndarray:
        w = self.w if x.ndim == 1 else self.w[:, None]
        return self.V @ (w * (self.V.conj().T @ x))


class DeviceQRCP(QRCP):
    """QRCP whose factorization runs on a GPU (K8, :func:`.qrcp_device`)
    during ``HIF.factorize`` (``Options.device_tail=1``); Q, R and piv come
    back to the host, so packing and solves are those of :class:`QRCP`.  A
    complex M takes the host QRCP: the device sweep is real only.  The
    rank uses ``opts.rrqr_cond``.  ``device`` defaults to "cuda"."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device

    def factorize(self, M: np.ndarray, opts=None) -> None:
        self.n = M.shape[0]
        if self.n == 0:
            self.rank = 0
            return
        if np.iscomplexobj(M):
            return QRCP.factorize(self, M, opts)
        import torch

        from ..device import resolve_device
        from .qrcp_device import qrcp_factor

        Q, R, piv, self.rank = qrcp_factor(
            torch.as_tensor(M, device=resolve_device(self.device)),
            getattr(opts, "rrqr_cond", 0.0) if opts is not None else 0.0)
        self.Q = Q.cpu().numpy()
        self.R = R.cpu().numpy()
        self.jpvt = piv.cpu().numpy()


def make_dense_solver(symm: bool, spd: int = 0, device: bool = False,
                      torch_device="cuda"):
    """Solver selection (ref ``small_scale/solver.hpp:42`` and
    ``Prec.hpp:104-127``): QRCP by default, SYEIG for symmetric systems;
    ``device`` runs the QRCP factorization on ``torch_device`` (K8)."""
    if symm:
        return SYEIG()
    return DeviceQRCP(torch_device) if device else QRCP()


DENSE_SOLVERS = {"qrcp": QRCP, "syeig": SYEIG, "lup": LUP}
