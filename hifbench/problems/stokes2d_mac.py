"""Enclosed-flow 2-D Stokes on the unit square, a MAC grid of nx x nx cells
(h = 1/nx), no-slip walls: A = [[-Lap_u, 0, Dx^T], [0, -Lap_v, Dy^T],
[Dx, Dy, 0]], u on the interior vertical faces, v on the interior
horizontal faces, p at the cell centres, in that order (n = 2 nx (nx-1) +
nx^2).  5-point Laplacians over h^2, the no-slip value of a velocity that
runs parallel to a wall imposed through a ghost node (3/h^2 in that
direction), D the cell divergence (+-1/h) and its transpose in the (1,3)
and (2,3) blocks, so A is exactly symmetric and singular, its null space
the constant pressure; a frozen copy of
``hifir_tpu_torch.models.problems.stokes2d_mac``."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def stokes2d_mac(nx: int) -> sp.csr_matrix:
    N, h = nx, 1.0 / nx
    nu = (N - 1) * N
    u = np.arange(nu).reshape(N, N - 1)
    v = nu + np.arange(nu).reshape(N - 1, N)
    p = 2 * nu + np.arange(N * N).reshape(N, N)
    rows, cols, vals = [], [], []

    def put(r, c, x):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.broadcast_to(np.asarray(x, dtype=np.float64),
                                    r.shape).ravel())

    for f, across in ((u, 0), (v, 1)):
        d = np.full(f.shape, 4.0)
        edge = [slice(None)] * 2
        for end in (0, -1):
            edge[across] = end
            d[tuple(edge)] += 1.0
        put(f, f, d / h ** 2)
        for ax in (0, 1):
            a = f[tuple(slice(None, -1) if k == ax else slice(None)
                        for k in range(2))]
            b = f[tuple(slice(1, None) if k == ax else slice(None)
                        for k in range(2))]
            put(a, b, -1.0 / h ** 2)
            put(b, a, -1.0 / h ** 2)
    for f, lo, hi in ((u, p[:, :-1], p[:, 1:]), (v, p[:-1, :], p[1:, :])):
        for c, s in ((lo, 1.0 / h), (hi, -1.0 / h)):
            put(c, f, s)
            put(f, c, s)
    n = 2 * nu + N * N
    A = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                             np.concatenate(cols))),
                      shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A


def make(config: dict):
    return stokes2d_mac(int(config["nx"]))


def null_rows(config: dict) -> slice:
    """The rows on which A's null vector is constant, zero elsewhere: the
    pressure's.  A right-hand side whose mean over them is zero is
    consistent."""
    n = int(config["nx"])
    return slice(2 * n * (n - 1), 2 * n * (n - 1) + n * n)
