"""The plain reference: the multilevel M-solve, the product M x and
restarted right-preconditioned GMRES, in numpy and scipy.

It imports neither jax, nor hifir_tpu, nor anything of hifir_tpu_torch.
It takes the host factorization as plain arrays (:mod:`hifbench.hostprec`)
and works out the rest again: the dense tail's factorization, every level's
triangular solves (scipy's), the scalings and permutations, the Krylov
iteration.  ``precision`` is the arithmetic: ``float64``, ``float32``, or
``tf32`` (float32 whose every stored operand and every stage's input is
rounded to TF32's 10-bit mantissa, as TF32 tensor cores round their
inputs), the lower precisions serving as the control (PERF.md).

The multilevel recursion is HIF's (hifirworks/hifir
``alg/prec_solve.hpp``): on a level with leading block B = (I + L) D (I + U)
and off blocks E, F of the scaled, permuted matrix,
``w = s[p] * b[p]``, ``y2 = w2 - E B^{-1} w1``, ``x2 = M_next^{-1} y2``,
``x1 = B^{-1} (w1 - F x2)``, ``x = t * [x1; x2][q^{-1}]``.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla

__all__ = ["Prec", "msolve", "mprod", "gmres", "round_tf32"]

_DTYPES = {"float64": np.float64, "float32": np.float32, "tf32": np.float32}


def round_tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to nearest (ties to even) on TF32's 10
    mantissa bits."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    u = a.view(np.uint32)
    u = (u + np.uint32(0x0FFF) + ((u >> np.uint32(13)) & np.uint32(1))) \
        & np.uint32(0xFFFFE000)
    return u.view(np.float32)


class Prec:
    """A host factorization prepared for one precision: every operand cast
    (and, for ``tf32``, rounded), the dense tail factorized here."""

    def __init__(self, levels, tail, precision: str = "float64"):
        self.precision = precision
        dt = _DTYPES[precision]
        self.rnd = round_tf32 if precision == "tf32" else (lambda a: a)

        def cast(a):
            return self.rnd(np.asarray(a, dtype=dt))

        def mat(T):
            T = T.astype(dt)
            T.data = cast(T.data)
            return T

        def unit(T):
            """I + T, canonical, for the triangular solves: scipy then sets
            the diagonal in place instead of inserting it every call."""
            T = (mat(T) + sp.eye(T.shape[0], dtype=dt, format="csr")).tocsr()
            T.sum_duplicates()
            T.sort_indices()
            return T

        self.levels = [dict(lv, L=mat(lv["L"]), U=mat(lv["U"]),
                            IL=unit(lv["L"]), IU=unit(lv["U"]),
                            E=mat(lv["E"]), F=mat(lv["F"]), d=cast(lv["d"]),
                            s_p=cast(lv["s"][lv["p"]]), t=cast(lv["t"]),
                            t_q=cast(lv["t"][lv["q"]]))
                       for lv in levels]
        self.tail = None if tail is None else self._tail(tail, cast)
        self.dtype = dt

    @staticmethod
    def _tail(D: np.ndarray, cast):
        """The dense tail's inverse on its numerical rank: a symmetric tail
        by its eigenpairs above n eps max|w| (HIF's SYEIG rule), any other
        by LU with partial pivoting."""
        D = np.asarray(D, dtype=np.float64)
        if np.array_equal(D, D.T):
            w, V = np.linalg.eigh(D)
            keep = np.abs(w) > D.shape[0] * np.finfo(np.float64).eps \
                * np.abs(w).max()
            return ("eig", cast(V[:, keep]), cast(w[keep]))
        lu, piv = sla.lu_factor(D)
        return ("lu", cast(lu), piv)

    def tail_solve(self, y: np.ndarray) -> np.ndarray:
        if self.tail is None:
            return y
        if self.tail[0] == "eig":
            _, V, w = self.tail
            z = self.rnd(V.T @ y)
            z = self.rnd(z / (w[:, None] if z.ndim == 2 else w))
            return V @ z
        _, lu, piv = self.tail
        return sla.lu_solve((lu, piv), y).astype(self.dtype)

    def tail_multiply(self, x: np.ndarray) -> np.ndarray:
        if self.tail is None:
            return x
        if self.tail[0] == "eig":
            _, V, w = self.tail
            z = V.T @ x
            return V @ ((w[:, None] if z.ndim == 2 else w) * z)
        _, lu, piv = self.tail
        n = lu.shape[0]
        Lf = np.tril(lu, -1) + np.eye(n)
        y = Lf @ (np.triu(lu) @ x)
        # P A = L U with the row swaps of getrf: undo them in reverse
        for i in range(n - 1, -1, -1):
            j = piv[i]
            if j != i:
                y[[i, j]] = y[[j, i]]
        return y

    def ldu_solve(self, lv: dict, y: np.ndarray) -> np.ndarray:
        """y <- (I + U)^{-1} D^{-1} (I + L)^{-1} y."""
        if lv["m"] == 0:
            return y
        y = spla.spsolve_triangular(lv["IL"], self.rnd(y), lower=True,
                                    unit_diagonal=True, overwrite_A=True)
        y = self.rnd(y / (lv["d"][:, None] if y.ndim == 2 else lv["d"]))
        return spla.spsolve_triangular(lv["IU"], y, lower=False,
                                       unit_diagonal=True, overwrite_A=True)


def _bc(v, a):
    return v[:, None] if a.ndim == 2 else v


def msolve(P: Prec, b: np.ndarray, level: int = 0) -> np.ndarray:
    """x = M^{-1} b for b of shape (n,) or (n, k), in ``P``'s precision."""
    lv = P.levels[level]
    m, n = lv["m"], lv["n"]
    b = np.asarray(b, dtype=P.dtype)
    w = P.rnd(_bc(lv["s_p"], b) * b[lv["p"]])
    x1 = P.ldu_solve(lv, w[:m])
    y2 = w[:0]
    if n - m:
        y2 = P.rnd(w[m:] - lv["E"] @ P.rnd(x1))
        y2 = (P.tail_solve(y2) if level + 1 == len(P.levels)
              else msolve(P, y2, level + 1))
        x1 = P.ldu_solve(lv, w[:m] - lv["F"] @ P.rnd(y2))
    sol = np.concatenate([x1, y2])
    return (_bc(lv["t"], b) * sol[lv["q_inv"]]).astype(P.dtype)


def mprod(P: Prec, x: np.ndarray, level: int = 0) -> np.ndarray:
    """y = M x for one vector: per level, (I + L) D (I + U) v1 + F v2 on
    the leading rows and E (v1 + B^{-1} F v2) + M_next v2 on the rest, in
    the scaled, permuted space (HIF's ``alg/prec_prod.hpp``)."""
    lv = P.levels[level]
    m, n = lv["m"], lv["n"]
    v = np.asarray(x, dtype=P.dtype)[lv["q"]] / lv["t_q"]
    v1, v2 = v[:m], v[m:]
    z = v1 + lv["U"] @ v1
    z = lv["d"] * z
    u1 = z + lv["L"] @ z
    u = u1
    if n - m:
        Fv2 = lv["F"] @ v2
        w = v1 + P.ldu_solve(lv, Fv2)
        nxt = (P.tail_multiply(v2) if level + 1 == len(P.levels)
               else mprod(P, v2, level + 1))
        u = np.concatenate([u1 + Fv2, lv["E"] @ w + nxt])
    y = np.empty(n, dtype=u.dtype)
    y[lv["p"]] = u / lv["s_p"]
    return y


def gmres(A, P: Prec, b: np.ndarray, restart: int, rtol: float,
          maxit: int, steps=None):
    """Right-preconditioned restarted GMRES(restart) from x0 = 0 in
    ``P``'s precision: classical Gram-Schmidt applied twice, Givens
    rotations, a restart cycle ends at |g[j+1]| <= rtol ||b|| or after
    ``restart`` steps.  With ``steps`` it runs exactly that many Arnoldi
    steps in all (the program's count, cycle by cycle) and ignores the
    tolerance.  Returns (x, steps done, converged)."""
    dt = P.dtype
    A = A.astype(dt)
    b = np.asarray(b, dtype=dt)
    n = b.shape[0]
    x = np.zeros(n, dtype=dt)
    bnrm = float(np.linalg.norm(b))
    limit = maxit if steps is None else steps
    total, conv = 0, False
    while total < limit and not conv:
        r = b - A @ x
        beta = np.linalg.norm(r)
        V = np.zeros((restart + 1, n), dtype=dt)
        Z = np.zeros((restart, n), dtype=dt)
        H = np.zeros((restart + 1, restart), dtype=dt)
        cs = np.zeros(restart, dtype=dt)
        sn = np.zeros(restart, dtype=dt)
        g = np.zeros(restart + 1, dtype=dt)
        g[0] = beta
        V[0] = r / beta if beta > 0 else r
        used = 0
        for j in range(min(restart, limit - total)):
            Z[j] = msolve(P, V[j])
            w = A @ Z[j]
            h = V[:j + 1] @ w
            w = w - h @ V[:j + 1]
            h2 = V[:j + 1] @ w
            w = w - h2 @ V[:j + 1]
            H[:j + 1, j] = h + h2
            H[j + 1, j] = np.linalg.norm(w)
            V[j + 1] = w / H[j + 1, j] if H[j + 1, j] > 0 else w
            for i in range(j):
                a, c = H[i, j], H[i + 1, j]
                H[i, j] = cs[i] * a + sn[i] * c
                H[i + 1, j] = -sn[i] * a + cs[i] * c
            rho = np.hypot(H[j, j], H[j + 1, j])
            cs[j], sn[j] = ((H[j, j] / rho, H[j + 1, j] / rho) if rho > 0
                            else (1.0, 0.0))
            H[j, j], H[j + 1, j] = rho, 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            used = j + 1
            if steps is None and abs(g[j + 1]) <= rtol * bnrm:
                conv = True
                break
        if used:
            y = sla.solve_triangular(H[:used, :used], g[:used])
            x = x + y @ Z[:used]
        total += used
    return x, total, conv
