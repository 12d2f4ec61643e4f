"""Model problem generators (the port's copy of ``hifir_tpu/models``)."""

from __future__ import annotations

import numpy as np

from ..ds.csr import CSR

__all__ = ["poisson2d"]


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
