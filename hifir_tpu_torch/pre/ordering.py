"""Fill-reducing orderings (ref ``src/hif/pre/reordering.hpp``,
``pre/amd.hpp``, ``pre/rcm.hpp``): the port's copy of
``hifir_tpu/pre/ordering.py``.

AMD (approximate minimum degree, Amestoy-Davis-Duff) and RCM run in the
native host library; without it (:func:`._native._load` gives ``None``)
both are scipy's reverse Cuthill-McKee, as in the JAX package.  Input is
the (sorted, symmetric-pattern) leading-block graph.
"""

from __future__ import annotations

import numpy as np

from ..ds.csr import CSR
from . import _native

__all__ = ["run_amd", "run_rcm", "symmetrize_pattern"]


def symmetrize_pattern(B: CSR) -> CSR:
    """Pattern of B + B^T with unit values (orderings need symmetric graphs)."""
    import scipy.sparse as sp

    S = B.to_scipy()
    P = (S + S.T).tocsr()
    P.data = np.ones_like(P.data)
    P.sort_indices()
    return CSR(B.nrows, B.ncols, P.indptr.astype(np.int64), P.indices, P.data)


def run_rcm(B: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrized pattern
    (ref ``pre/rcm.hpp`` George-Liu BFS with pseudo-peripheral root)."""
    P = symmetrize_pattern(B)
    perm = _native.rcm(P.nrows, P.indptr, P.indices)
    if perm is not None:
        return perm
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(
        reverse_cuthill_mckee(P.to_scipy(), symmetric_mode=True),
        dtype=np.int64)


def run_amd(B: CSR) -> np.ndarray:
    """Approximate minimum degree ordering (ref ``pre/amd.hpp``: templated port
    of AMD TOMS 837); RCM without the native library."""
    P = symmetrize_pattern(B)
    perm = _native.amd(P.nrows, P.indptr, P.indices)
    if perm is not None:
        return perm
    return run_rcm(B)
