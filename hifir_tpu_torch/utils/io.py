"""Matrix Market and native binary IO.

The port's copy of ``hifir_tpu/utils/io.py``, the replacement of the
reference IO layer (``src/hif/utils/io.hpp:309-545`` for MatrixMarket
matrices, ``:767`` read, ``:833`` write, and the HDF5 native binary at
``:76-303``).  Matrices come back as host
:class:`~hifir_tpu_torch.ds.csr.CSR`; the native binary format uses
``numpy.savez`` instead of HDF5, so a file either package writes reads in
the other.
"""

from __future__ import annotations

import gzip
from typing import TYPE_CHECKING, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from ..ds.csr import CSR

__all__ = [
    "query_mm",
    "read_mm",
    "read_mm_vector",
    "write_mm",
    "write_mm_vector",
    "read_native",
    "write_native",
]


def _open(fname: str, mode: str = "rt"):
    if str(fname).endswith(".gz"):
        return gzip.open(fname, mode)
    return open(fname, mode)


def query_mm(fname: str) -> dict:
    """Inspect a MatrixMarket file header without reading the data
    (ref ``lhfQueryMmFile``, ``libhifir.h:303``).

    Returns ``{is_sparse, is_real, nrows, ncols, nnz}``; for a dense array
    file ``nrows`` is the array length and ``ncols``/``nnz`` are 0 (the
    reference convention).
    """
    with _open(fname) as f:
        header = f.readline().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            raise ValueError(f"{fname}: not a MatrixMarket file")
        _, obj, fmt, field, _symm = header[:5]
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        sizes = [int(v) for v in line.split()]
    is_sparse = fmt == "coordinate"
    if is_sparse:
        nrows, ncols, nnz = sizes
    else:
        nrows, ncols, nnz = sizes[0] * sizes[1], 0, 0
    return {"is_sparse": is_sparse, "is_real": field != "complex",
            "nrows": nrows, "ncols": ncols, "nnz": nnz}


def read_mm(fname: str):
    """Read a MatrixMarket coordinate file into a host CSR matrix.

    Supports real/complex/integer/pattern fields and general/symmetric/
    hermitian/skew-symmetric symmetries (expanded to full storage), matching
    the reference reader (``utils/io.hpp:309-545``).
    """
    from ..ds.csr import CSR  # local import to avoid cycle

    with _open(fname) as f:
        header = f.readline().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            raise ValueError(f"{fname}: not a MatrixMarket file")
        _, obj, fmt, field, symm = header[:5]
        if obj != "matrix" or fmt != "coordinate":
            raise ValueError(f"{fname}: expected coordinate matrix, got {obj}/{fmt}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols, nnz = (int(v) for v in line.split())
        complex_vals = field == "complex"
        pattern = field == "pattern"
        rows = np.empty(nnz, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int64)
        vals = np.empty(nnz, dtype=np.complex128 if complex_vals else np.float64)
        for k in range(nnz):
            parts = f.readline().split()
            rows[k] = int(parts[0]) - 1
            cols[k] = int(parts[1]) - 1
            if pattern:
                vals[k] = 1.0
            elif complex_vals:
                vals[k] = complex(float(parts[2]), float(parts[3]))
            else:
                vals[k] = float(parts[2])

    if symm in ("symmetric", "hermitian", "skew-symmetric"):
        off = rows != cols
        extra_r, extra_c, extra_v = cols[off], rows[off], vals[off]
        if symm == "hermitian":
            extra_v = np.conj(extra_v)
        elif symm == "skew-symmetric":
            extra_v = -extra_v
        rows = np.concatenate([rows, extra_r])
        cols = np.concatenate([cols, extra_c])
        vals = np.concatenate([vals, extra_v])

    return CSR.from_coo(nrows, ncols, rows, cols, vals)


def read_mm_vector(fname: str) -> np.ndarray:
    """Read a dense MatrixMarket array file (vector or tall matrix)."""
    with _open(fname) as f:
        header = f.readline().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            raise ValueError(f"{fname}: not a MatrixMarket file")
        _, obj, fmt, field, _symm = header[:5]
        if fmt != "array":
            raise ValueError(f"{fname}: expected array format for vector read")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrows, ncols = (int(v) for v in line.split())
        complex_vals = field == "complex"
        out = np.empty(nrows * ncols, dtype=np.complex128 if complex_vals else np.float64)
        for k in range(nrows * ncols):
            parts = f.readline().split()
            out[k] = complex(float(parts[0]), float(parts[1])) if complex_vals else float(parts[0])
    # MM arrays are column-major
    return out.reshape(ncols, nrows).T.squeeze()


def write_mm(fname: str, A: "CSR") -> None:
    """Write a host CSR matrix as a general coordinate MatrixMarket file."""
    complex_vals = np.iscomplexobj(A.data)
    field = "complex" if complex_vals else "real"
    rows = np.repeat(np.arange(1, A.nrows + 1, dtype=np.int64),
                     np.diff(A.indptr))
    with _open(fname, "wt") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        f.write(f"{A.nrows} {A.ncols} {A.nnz}\n")
        if complex_vals:
            np.savetxt(f, np.column_stack(
                [rows, A.indices + 1, A.data.real, A.data.imag]),
                fmt="%d %d %.17g %.17g")
        else:
            np.savetxt(f, np.column_stack([rows, A.indices + 1, A.data]),
                       fmt="%d %d %.17g")


def write_mm_vector(fname: str, v: np.ndarray) -> None:
    """Write a dense vector as a MatrixMarket array file."""
    v = np.asarray(v)
    complex_vals = np.iscomplexobj(v)
    field = "complex" if complex_vals else "real"
    with _open(fname, "wt") as f:
        f.write(f"%%MatrixMarket matrix array {field} general\n")
        f.write(f"{v.shape[0]} 1\n")
        for x in v:
            if complex_vals:
                f.write(f"{x.real:.17g} {x.imag:.17g}\n")
            else:
                f.write(f"{x:.17g}\n")


def write_native(fname: str, A: "CSR") -> None:
    """Native binary dump (replaces the reference HDF5 path)."""
    np.savez_compressed(
        fname,
        indptr=A.indptr,
        indices=A.indices,
        data=A.data,
        shape=np.array([A.nrows, A.ncols], dtype=np.int64),
    )


def read_native(fname: str):
    from ..ds.csr import CSR

    with np.load(fname) as z:
        return CSR(
            int(z["shape"][0]),
            int(z["shape"][1]),
            z["indptr"],
            z["indices"],
            z["data"],
        )
