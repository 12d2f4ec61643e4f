"""Minimal host CSR container.

The port's own copy of the parts of ``hifir_tpu/ds/csr.py`` that packing and
loading use: construction (``from_coo``), scipy round trips and the explicit
transpose that the adjoint solves and products pack.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["CSR"]


class CSR:
    """Compressed sparse row matrix on host (numpy); indices sorted per row."""

    __slots__ = ("nrows", "ncols", "indptr", "indices", "data")

    def __init__(self, nrows: int, ncols: int, indptr, indices, data):
        self.nrows = int(nrows)
        self.ncols = int(ncols)
        self.indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        self.indices = np.ascontiguousarray(indices, dtype=np.int32)
        self.data = np.ascontiguousarray(data)

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

    def transpose(self) -> "CSR":
        """Explicit transpose (a counting sort, scipy's CSR to CSC)."""
        T = self.to_scipy().tocsc()
        T.sort_indices()
        return CSR(self.ncols, self.nrows, T.indptr.astype(np.int64),
                   T.indices, T.data)

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)
