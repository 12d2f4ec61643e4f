"""Host CSR container.

The port's copy of the parts of ``hifir_tpu/ds/csr.py`` that loading,
packing, the host factorize and the host solves use: construction
(``from_coo``, ``csr_from_dense``, ``identity``), scipy round trips,
``copy``, validation, the explicit transpose (and its cached CSC view),
row and column scalings, ``permute``, ``prune``, the leading block, the
diagonal, the pattern-symmetry ratio, the products
``A x`` and ``A^T x`` / ``A^H x`` and the unit strict-triangular solves.
The diagonal, the ratio and the solves run in the native host library
(:mod:`..pre._native`) when it is loaded, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["CSR", "csr_from_dense"]


class CSR:
    """Compressed sparse row matrix on host (numpy); indices sorted and
    unique per row."""

    __slots__ = ("nrows", "ncols", "indptr", "indices", "data", "_csc")

    def __init__(self, nrows: int, ncols: int, indptr, indices, data):
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self.data = np.ascontiguousarray(data)
        self._csc: Optional["CSR"] = None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_coo(cls, nrows, ncols, rows, cols, vals) -> "CSR":
        """Build from coordinate triplets; duplicates are summed."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if rows.size:
            new_grp = np.empty(rows.size, dtype=bool)
            new_grp[0] = True
            new_grp[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            grp_id = np.cumsum(new_grp) - 1
            out_vals = np.zeros(grp_id[-1] + 1, dtype=vals.dtype)
            np.add.at(out_vals, grp_id, vals)
            keep = np.flatnonzero(new_grp)
            rows, cols, vals = rows[keep], cols[keep], out_vals
        indptr = np.zeros(nrows + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(nrows, ncols, indptr, cols.astype(np.int32), vals)

    @classmethod
    def from_scipy(cls, A) -> "CSR":
        A = A.tocsr()
        A.sort_indices()
        return cls(A.shape[0], A.shape[1], A.indptr, A.indices, A.data)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr),
                             shape=(self.nrows, self.ncols))

    @classmethod
    def identity(cls, n: int, dtype=np.float64) -> "CSR":
        return cls(n, n, np.arange(n + 1), np.arange(n, dtype=np.int32),
                   np.ones(n, dtype=dtype))

    # -- basics -------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def dtype(self):
        return self.data.dtype

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def copy(self) -> "CSR":
        return CSR(self.nrows, self.ncols, self.indptr.copy(),
                   self.indices.copy(), self.data.copy())

    def astype(self, dtype) -> "CSR":
        return CSR(self.nrows, self.ncols, self.indptr, self.indices,
                   self.data.astype(dtype))

    def check_validity(self) -> None:
        """Structural validation (ref ``CompressedStorage.hpp:193``)."""
        from ..utils.log import hif_error

        if self.indptr.shape[0] != self.nrows + 1:
            hif_error("indptr size %d != nrows+1 %d", self.indptr.shape[0],
                      self.nrows + 1)
        if self.indptr[0] != 0 or self.indptr[-1] != self.indices.shape[0]:
            hif_error("corrupted indptr bounds")
        if np.any(np.diff(self.indptr) < 0):
            hif_error("negative row counts in indptr")
        if self.indices.size:
            if self.indices.min() < 0 or self.indices.max() >= self.ncols:
                hif_error("column index out of bounds")
            # adjacent pairs must strictly increase except across row
            # boundaries
            d = np.diff(self.indices.astype(np.int64))
            boundary = np.zeros(max(self.indices.size - 1, 0), dtype=bool)
            ends = self.indptr[1:-1]
            ends = ends[(ends > 0) & (ends < self.indices.size)]
            boundary[ends - 1] = True
            if np.any((d <= 0) & ~boundary):
                hif_error("row indices not sorted/unique")

    def todense(self) -> np.ndarray:
        out = np.zeros((self.nrows, self.ncols), dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        out[rows, self.indices] = self.data
        return out

    # -- transpose / CSC view ----------------------------------------------
    def transpose(self) -> "CSR":
        """Explicit transpose (a counting sort, scipy's CSR to CSC)."""
        T = self.to_scipy().tocsc()
        T.sort_indices()
        return CSR(self.ncols, self.nrows, T.indptr.astype(np.int64),
                   T.indices, T.data)

    def tocsc(self) -> "CSR":
        """CSR holding the transpose; (indptr, indices) read as CSC of self.
        Computed once and cached."""
        if self._csc is None:
            self._csc = self.transpose()
        return self._csc

    # -- products, scalings, blocks ----------------------------------------
    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A x; ``x`` may be (ncols,) or an (ncols, k) block."""
        x = np.asarray(x)
        data = self.data if x.ndim == 1 else self.data[:, None]
        prod = data * x[self.indices]
        shape = (self.nrows,) if x.ndim == 1 else (self.nrows, x.shape[1])
        y = np.zeros(shape, dtype=np.result_type(self.data, x))
        if prod.size:
            nz = np.flatnonzero(np.diff(self.indptr))
            y[nz] = np.add.reduceat(prod, self.indptr[nz], axis=0)
        return y

    def matvec_tran(self, x: np.ndarray, conj: bool = False) -> np.ndarray:
        """y = A^T x (``conj``: A^H x); ``x`` may be (nrows,) or a block."""
        x = np.asarray(x)
        data = np.conj(self.data) if conj else self.data
        if x.ndim == 2:
            data = data[:, None]
            y = np.zeros((self.ncols, x.shape[1]),
                         dtype=np.result_type(self.data, x))
        else:
            y = np.zeros(self.ncols, dtype=np.result_type(self.data, x))
        rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        np.add.at(y, self.indices, data * x[rows])
        return y

    def scale_diag_left(self, s: np.ndarray) -> "CSR":
        """Row scaling diag(s) @ A (ref ``scale_diag_left``, ``:1045``)."""
        rows = np.repeat(np.arange(self.nrows), self.row_nnz())
        return CSR(self.nrows, self.ncols, self.indptr, self.indices,
                   self.data * s[rows])

    def scale_diag_right(self, t: np.ndarray) -> "CSR":
        return CSR(self.nrows, self.ncols, self.indptr, self.indices,
                   self.data * t[self.indices])

    def permute(self, p: np.ndarray, q_inv: np.ndarray) -> "CSR":
        """A[p, :] with columns remapped by q_inv, each row's columns sorted
        (ref ``compute_perm``, ``CompressedStorage.hpp:551,1680``)."""
        p = np.asarray(p, dtype=np.int64)
        counts = self.row_nnz()[p]
        indptr = np.zeros(self.nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        # the source position of every entry, row after row of A[p, :]
        src = (np.repeat(self.indptr[p] - indptr[:-1], counts)
               + np.arange(indptr[-1]))
        cols = np.asarray(q_inv, dtype=np.int64)[self.indices[src]]
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), counts)
        order = np.lexsort((cols, rows))
        return CSR(self.nrows, self.ncols, indptr, cols[order],
                   self.data[src[order]])

    def prune(self, tol: float = 0.0) -> "CSR":
        """Drop entries with magnitude <= tol (ref ``prune``, ``:1733``)."""
        keep = np.abs(self.data) > tol
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64),
                         self.row_nnz())
        return CSR.from_coo(self.nrows, self.ncols, rows[keep],
                            self.indices[keep].astype(np.int64),
                            self.data[keep])

    def extract_leading(self, m: int) -> "CSR":
        """Leading m-by-m block (ref ``extract_leading``, ``:1712``)."""
        end = int(self.indptr[m])
        rows = np.repeat(np.arange(m, dtype=np.int64), self.row_nnz()[:m])
        keep = self.indices[:end] < m
        indptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows[keep], minlength=m), out=indptr[1:])
        return CSR(m, m, indptr, self.indices[:end][keep],
                   self.data[:end][keep])

    def diagonal(self) -> np.ndarray:
        nd = min(self.nrows, self.ncols)
        if self.data.dtype == np.float64:
            from ..pre import _native

            out = _native.diagonal(self, nd)
            if out is not None:
                return out
        d = np.zeros(nd, dtype=self.data.dtype)
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64),
                         self.row_nnz())
        on_diag = rows == self.indices
        if nd < self.nrows:
            on_diag &= rows < nd
        d[rows[on_diag]] = self.data[on_diag]
        return d

    def pattern_symm_ratio(self) -> float:
        """Fraction of entries whose transpose position is also present
        (ref ``compute_pattern_symm_ratio``, ``alg/factor.hpp:507``)."""
        if self.nnz == 0:
            return 1.0
        if self.nrows == self.ncols:
            from ..pre import _native

            r = _native.pattern_symm(self.nrows, self.indptr, self.indices)
            if r is not None:
                return r
        # membership of transposed positions in the (globally sorted)
        # row-major key sequence
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64),
                         self.row_nnz())
        keys = rows * np.int64(self.ncols) + self.indices.astype(np.int64)
        tkeys = self.indices.astype(np.int64) * np.int64(self.ncols) + rows
        pos = np.minimum(np.searchsorted(keys, tkeys), keys.size - 1)
        return float((keys[pos] == tkeys).sum()) / float(self.nnz)

    # -- unit strict-triangular solves (host) ------------------------------
    def solve_as_strict_lower(self, b: np.ndarray) -> np.ndarray:
        """x = (I + strict_lower(A))^{-1} b (ref ``solve_as_strict_lower``,
        ``:1358``); ``b`` may be (n,) or an (n, k) block.  The native
        kernel for real f32/f64, a row loop otherwise."""
        return self._solve_strict(b, lower=True)

    def solve_as_strict_upper(self, b: np.ndarray) -> np.ndarray:
        """x = (I + strict_upper(A))^{-1} b (ref ``:1451``)."""
        return self._solve_strict(b, lower=False)

    def _solve_strict(self, b, lower: bool) -> np.ndarray:
        from ..pre import _native

        if (self.data.dtype in (np.float64, np.float32)
                and not np.iscomplexobj(b)):
            x = _native.trsv(self, np.asarray(b, dtype=self.data.dtype),
                             lower)
            if x is not None:
                return x
        x = np.array(b, copy=True)
        rng = range(self.nrows) if lower else range(self.nrows - 1, -1, -1)
        for i in rng:
            s, e = self.indptr[i], self.indptr[i + 1]
            cols = self.indices[s:e]
            mask = cols < i if lower else cols > i
            if mask.any():
                x[i] -= self.data[s:e][mask] @ x[cols[mask]]
        return x


def csr_from_dense(M: np.ndarray, tol: float = 0.0) -> CSR:
    """The entries of a dense M with magnitude above ``tol``."""
    rows, cols = np.nonzero(np.abs(M) > tol)
    return CSR.from_coo(M.shape[0], M.shape[1], rows, cols, M[rows, cols])
