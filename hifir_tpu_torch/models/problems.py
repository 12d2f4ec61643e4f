"""Model problem generators (the port's copy of ``hifir_tpu/models``):
2-D/3-D Poisson, convection-diffusion (5/7-point FDM), a saddle-point
Stokes-like system with a zero (2,2) block, which exercises the static
deferral, enclosed-flow 2-D Stokes on a MAC grid, random sparse and
strict-triangular test matrices, and a complex diagonal shift."""

from __future__ import annotations

import numpy as np

from ..ds.csr import CSR

__all__ = ["poisson2d", "poisson3d", "convdiff2d", "saddle_point_stokes",
           "stokes2d_mac", "random_sparse", "random_strict_triangular",
           "shift_diagonal"]


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


def poisson3d(nx: int, ny: int | None = None, nz: int | None = None,
              dtype=np.float64) -> CSR:
    """7-point 3-D Poisson (SPD, n = nx*ny*nz)."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n).reshape(nz, ny, nx)
    rows = [np.arange(n)]
    cols = [np.arange(n)]
    vals = [np.full(n, 6.0, dtype=dtype)]
    pairs = [
        (idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()),
        (idx[:, :-1, :].ravel(), idx[:, 1:, :].ravel()),
        (idx[:-1, :, :].ravel(), idx[1:, :, :].ravel()),
    ]
    for r, c in pairs:
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


def saddle_point_stokes(nx: int, dtype=np.float64, seed: int = 0) -> CSR:
    """Small saddle-point system [[A, B^T], [B, 0]]: A the 5-point Poisson
    operator, B a seeded random sparse matrix with three normal entries a
    row.  It is no discretized Stokes operator, and it is not singular by
    construction; :func:`stokes2d_mac` is the enclosed-flow Stokes operator.

    The zero (2,2) block produces structurally zero diagonals exercising the
    static-deferral machinery (ref ``pre/matching_scaling.hpp:99-183``).
    """
    A = poisson2d(nx, dtype=dtype)
    n = A.nrows
    m = n // 4
    rng = np.random.default_rng(seed)
    # simple random sparse divergence-like operator B (m x n)
    nnz_per_row = 3
    rows = np.repeat(np.arange(m), nnz_per_row)
    cols = rng.integers(0, n, size=m * nnz_per_row)
    vals = rng.standard_normal(m * nnz_per_row).astype(dtype)
    B = CSR.from_coo(m, n, rows, cols, vals)
    import scipy.sparse as sp

    S = sp.bmat([[A.to_scipy(), B.to_scipy().T], [B.to_scipy(), None]],
                format="csr")
    return CSR.from_scipy(S)


def stokes2d_mac(N: int, dtype=np.float64) -> CSR:
    """Enclosed-flow 2-D Stokes on the unit square, a MAC grid of N x N
    cells (h = 1/N), no-slip walls:
    A = [[-Lap_u, 0, Dx^T], [0, -Lap_v, Dy^T], [Dx, Dy, 0]].

    u lives on the interior vertical faces ((N-1) x N, x fastest), v on the
    interior horizontal faces (N x (N-1)), p at the cell centres (N x N),
    in that order: n = 2 N (N-1) + N^2.  The Laplacians are 5-point, scaled
    by 1/h^2; a neighbour on a wall normal to the velocity is the wall's
    zero, and where the velocity runs parallel to a wall its no-slip value
    is imposed through a ghost node (u_ghost = -u), so the diagonal is
    3/h^2 in that direction.  D is the cell divergence (+-1/h); the (1,3)
    and (2,3) blocks are its transpose (the pressure's sign folded in), so
    A is exactly symmetric.  It is singular: its null space is the
    constant pressure (0, 0, 1_p).
    """
    h = 1.0 / N
    nu = (N - 1) * N
    # face indices, [row j, column i]; p[j, i] the cell of row j, column i
    u = np.arange(nu).reshape(N, N - 1)              # x-face i + 1 of row j
    v = nu + np.arange(nu).reshape(N - 1, N)         # y-face j + 1 of col i
    p = 2 * nu + np.arange(N * N).reshape(N, N)
    rows, cols, vals = [], [], []

    def put(r, c, x):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.broadcast_to(np.asarray(x, dtype=np.float64),
                                    r.shape).ravel())

    for f, across in ((u, 0), (v, 1)):
        # the diagonal: 2 along the velocity (wall faces are zeros), 2
        # across it, 3 beside a wall it runs parallel to (the ghost node)
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
    # divergence: u face i + 1 of row j is the right face of cell (j, i)
    # and the left face of cell (j, i + 1); likewise v in y
    for f, lo, hi in ((u, p[:, :-1], p[:, 1:]), (v, p[:-1, :], p[1:, :])):
        for c, s in ((lo, 1.0 / h), (hi, -1.0 / h)):
            put(c, f, s)
            put(f, c, s)
    n = 2 * nu + N * N
    return CSR.from_coo(n, n, np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals).astype(dtype))


def random_sparse(n: int, nnz_per_row: int = 8, diag: bool = True,
                  dtype=np.float64, seed: int = 0, ncols: int | None = None) -> CSR:
    """Random sparse test matrix (analog of ``tests/common.hpp:393``)."""
    ncols = ncols or n
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max(2, nnz_per_row + 1), size=n)
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, ncols, size=counts.sum())
    vals = rng.standard_normal(counts.sum()).astype(dtype)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        vals = vals + 1j * rng.standard_normal(counts.sum())
    A = CSR.from_coo(n, ncols, rows, cols, vals)
    if diag and n == ncols:
        # add a dominant-ish diagonal to keep factorization well-posed
        D = CSR(n, n, np.arange(n + 1), np.arange(n, dtype=np.int32),
                (nnz_per_row + rng.random(n)).astype(A.data.dtype))
        A = CSR.from_scipy(A.to_scipy() + D.to_scipy())
    return A


def random_strict_triangular(n: int, lower: bool, nnz_per_row: int = 4,
                             dtype=np.float64, seed: int = 0) -> CSR:
    """Random strict triangular pattern (analog of ``tests/common.hpp:507``)."""
    rng = np.random.default_rng(seed)
    rows_l, cols_l, vals_l = [], [], []
    for i in range(n):
        lim = i if lower else n - i - 1
        if lim <= 0:
            continue
        k = min(lim, rng.integers(0, nnz_per_row + 1))
        if k == 0:
            continue
        base = rng.choice(lim, size=k, replace=False)
        c = base if lower else i + 1 + base
        rows_l.append(np.full(k, i))
        cols_l.append(c)
        vals_l.append(rng.standard_normal(k).astype(dtype))
    if rows_l:
        return CSR.from_coo(n, n, np.concatenate(rows_l),
                            np.concatenate(cols_l), np.concatenate(vals_l))
    return CSR(n, n, np.zeros(n + 1, dtype=np.int64),
               np.empty(0, dtype=np.int32), np.empty(0, dtype=dtype))


def shift_diagonal(A: CSR, shift: complex = -0.1 + 0.1j) -> CSR:
    """``A + shift * diag(|a_ii|)`` in complex128: a complex nonsymmetric
    operator from a real one (``shift_diagonal(convdiff2d(128))`` is the
    operator of ``hifir_tpu_torch/data/convdiff2d_128_c_prec.npz``), the
    kind that frequency-domain convection-diffusion and Helmholtz-type
    problems give."""
    import scipy.sparse as sp

    S = A.to_scipy().astype(np.complex128)
    return CSR.from_scipy(S + shift * sp.diags(np.abs(S.diagonal())))
