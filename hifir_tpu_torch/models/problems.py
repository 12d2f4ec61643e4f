"""Model problem generators (the port's copy of ``hifir_tpu/models``)."""

from __future__ import annotations

import numpy as np

from ..ds.csr import CSR

__all__ = ["poisson2d", "convdiff2d", "shift_diagonal"]


def poisson2d(nx: int, ny: int | None = None, dtype=np.float64) -> CSR:
    """5-point 2-D Poisson on an nx-by-ny grid (SPD, n = nx*ny)."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n).reshape(ny, nx)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 4.0, dtype=dtype)]
    for r, c in ((idx[:, :-1].ravel(), idx[:, 1:].ravel()),
                 (idx[:-1, :].ravel(), idx[1:, :].ravel())):
        for a, b in ((r, c), (c, r)):
            rows.append(a)
            cols.append(b)
            vals.append(np.full(a.size, -1.0, dtype=dtype))
    return CSR.from_coo(n, n, np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals))


def convdiff2d(nx: int, ny: int | None = None, wind=(10.0, 20.0),
               dtype=np.float64) -> CSR:
    """2-D convection-diffusion, upwind FDM (nonsymmetric)."""
    ny = ny or nx
    n = nx * ny
    h = 1.0 / (nx + 1)
    bx, by = wind
    idx = np.arange(n).reshape(ny, nx)
    diag = 4.0 + h * (abs(bx) + abs(by))
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, diag, dtype=dtype)]
    west = -(1.0 + (h * bx if bx > 0 else 0.0))
    east = -(1.0 - (h * bx if bx < 0 else 0.0))
    south = -(1.0 + (h * by if by > 0 else 0.0))
    north = -(1.0 - (h * by if by < 0 else 0.0))
    pairs = [
        (idx[:, 1:].ravel(), idx[:, :-1].ravel(), west),
        (idx[:, :-1].ravel(), idx[:, 1:].ravel(), east),
        (idx[1:, :].ravel(), idx[:-1, :].ravel(), south),
        (idx[:-1, :].ravel(), idx[1:, :].ravel(), north),
    ]
    for r, c, v in pairs:
        rows.append(r)
        cols.append(c)
        vals.append(np.full(r.size, v, dtype=dtype))
    return CSR.from_coo(n, n, np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals))


def shift_diagonal(A: CSR, shift: complex = -0.1 + 0.1j) -> CSR:
    """``A + shift * diag(|a_ii|)`` in complex128: a complex nonsymmetric
    operator from a real one (``shift_diagonal(convdiff2d(128))`` is the
    operator of ``hifir_tpu_torch/data/convdiff2d_128_c_prec.npz``), the
    kind that frequency-domain convection-diffusion and Helmholtz-type
    problems give."""
    import scipy.sparse as sp

    S = A.to_scipy().astype(np.complex128)
    return CSR.from_scipy(S + shift * sp.diags(np.abs(S.diagonal())))
